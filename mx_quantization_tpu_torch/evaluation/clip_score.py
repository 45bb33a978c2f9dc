"""CLIP score (port of the JAX package's ``evaluation/clip_score.py``; the
reference's PixArt/evaluation/clip_score.py:9-33):
score = 100 * max(0, cos(image embed, text embed)), averaged over pairs.

``clip_score_from_features`` scores embeddings from any CLIP;
``clip_score_port`` runs both of the port's CLIP towers on the device
(JAX's ``clip_score_jax``: the port's towers); ``clip_score_transformers``
runs transformers' CLIPModel on the CPU (JAX's ``clip_score_torch``).
Both read a local checkpoint (transformers reads local files only, never
the hub) and tokenize with transformers (imported when called).
"""

from __future__ import annotations

import numpy as np


def clip_score_from_features(image_embs: np.ndarray, text_embs: np.ndarray
                             ) -> float:
    """Mean CLIP score over aligned (N, D) image / text embedding pairs."""
    i = image_embs / np.linalg.norm(image_embs, axis=-1, keepdims=True)
    t = text_embs / np.linalg.norm(text_embs, axis=-1, keepdims=True)
    cos = np.sum(i * t, axis=-1)
    return float(np.mean(100.0 * np.maximum(cos, 0.0)))


def clip_score_transformers(images: np.ndarray, prompts, model_path: str,
                            batch: int = 64) -> float:
    """CLIP score with a local transformers CLIP checkpoint on the CPU
    (torchmetrics' CLIPScore with clip-vit-large-patch14).  ``images``:
    (N, H, W, 3) uint8; ``prompts``: N strings."""
    import torch
    from transformers import CLIPModel, CLIPProcessor

    model = CLIPModel.from_pretrained(model_path, local_files_only=True)
    processor = CLIPProcessor.from_pretrained(model_path,
                                              local_files_only=True)
    model.eval()
    scores = []
    with torch.no_grad():
        for i in range(0, len(images), batch):
            ims = [images[j] for j in range(i, min(i + batch, len(images)))]
            inputs = processor(text=prompts[i:i + batch], images=ims,
                               return_tensors="pt", padding=True,
                               truncation=True)
            out = model(**inputs)
            ie = out.image_embeds / out.image_embeds.norm(dim=-1,
                                                          keepdim=True)
            te = out.text_embeds / out.text_embeds.norm(dim=-1, keepdim=True)
            cos = (ie * te).sum(-1)
            scores.append(100.0 * torch.clamp(cos, min=0).cpu().numpy())
    return float(np.mean(np.concatenate(scores)))


def clip_score_port(images: np.ndarray, prompts, model_path: str,
                    batch: int = 64, mx_specs=None, device="cuda") -> float:
    """CLIP score with both of the port's CLIP towers on ``device``
    (``models/clip.py``); only the tokenization is transformers'
    CLIPTokenizer, on the host.  ``images``: (N, H, W, 3) uint8;
    ``prompts``: N strings; ``mx_specs`` runs the towers MX-quantized."""
    import torch
    from transformers import CLIPTokenizer

    from ..models.clip import (clip_image_embed, clip_text_embed,
                               load_clip_from_pretrained, preprocess_images)

    cfg, model = load_clip_from_pretrained(model_path, device)
    tok = CLIPTokenizer.from_pretrained(model_path, local_files_only=True)
    scores = []
    for i in range(0, len(images), batch):
        px = preprocess_images(images[i:i + batch], cfg, device)
        enc = tok(list(prompts[i:i + batch]), padding="max_length",
                  truncation=True, max_length=cfg.max_positions,
                  return_tensors="np")
        ie = clip_image_embed(model, px, mx_specs=mx_specs)
        te = clip_text_embed(
            model, torch.from_numpy(enc["input_ids"].astype(np.int64)),
            torch.from_numpy(enc["attention_mask"]), mx_specs=mx_specs)
        scores.append(clip_score_from_features(
            ie.float().cpu().numpy(), te.float().cpu().numpy()) * len(ie))
    return float(sum(scores) / len(images))
