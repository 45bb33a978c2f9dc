"""npz packers (port of the JAX package's ``evaluation/npz_io.py``; the
reference's DiT/evaluations/to_NPZ.py and PixArt/evaluation/toNPZ.py):
image folders to uint8 npz arrays for the evaluator, latents-space images
to uint8, COCO captions to a prompt file."""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def images_to_npz(image_dir: str, out_path: str, size: Optional[int] = 256,
                  limit: Optional[int] = None) -> str:
    """Pack PNG/JPEG files into an (N, H, W, 3) uint8 npz under "arr_0" (the
    ADM evaluator's layout), resized bicubically to ``size`` where they
    differ."""
    from PIL import Image
    files = sorted(f for f in os.listdir(image_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if limit:
        files = files[:limit]
    arrs = []
    for f in files:
        img = Image.open(os.path.join(image_dir, f)).convert("RGB")
        if size is not None and img.size != (size, size):
            img = img.resize((size, size), Image.BICUBIC)
        arrs.append(np.asarray(img, np.uint8))
    np.savez(out_path, arr_0=np.stack(arrs))
    return out_path


def load_npz_images(path: str) -> np.ndarray:
    with np.load(path) as f:
        key = "arr_0" if "arr_0" in f else list(f.keys())[0]
        return f[key]


def latents_to_images(latents: np.ndarray) -> np.ndarray:
    """(N, C, H, W) floats in about [-1, 1] -> (N, H, W, C) uint8 (the
    reference's save path: clamp, scale by 127.5 and shift by 127.5)."""
    x = np.transpose(latents, (0, 2, 3, 1))
    return np.clip(x * 127.5 + 127.5, 0, 255).astype(np.uint8)


def extract_coco_captions(annotation_json: str, out_txt: str,
                          limit: int = 5000) -> str:
    """COCO val captions, one per image ordered by image id, to a
    one-prompt-per-line text file (the coco2017_val5000.txt prompt sets)."""
    with open(annotation_json) as f:
        ann = json.load(f)
    seen = {}
    for a in ann["annotations"]:
        seen.setdefault(a["image_id"], a["caption"].strip().replace("\n", " "))
    prompts = [seen[i] for i in sorted(seen)][:limit]
    with open(out_txt, "w") as f:
        f.write("\n".join(prompts) + "\n")
    return out_txt
