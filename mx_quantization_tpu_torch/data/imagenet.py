"""ImageNet-folder input pipeline (port of the JAX package's
``data/imagenet.py``).

Lists val/<wnid>/*.JPEG with classes sorted by name (torchvision
ImageFolder's indices), decodes with PIL, resizes the short side to
img_size / 0.875 bicubically, centre-crops img_size, normalizes, and batches
as NCHW float32 numpy arrays: the reference's eval transform.  PIL is
imported at the first decode, so the module imports without it.
``native=True`` takes the C++ loader instead (``native/``: libjpeg, a
bilinear resize, a double-buffered iterator), and the PIL decode where that
loader cannot be built or loaded, as the JAX package does.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_EXTS = (".jpeg", ".jpg", ".png", ".JPEG", ".JPG", ".PNG")


def list_imagenet(root: str) -> Tuple[List[str], List[int]]:
    """(file paths, integer labels), classes sorted by directory name."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for idx, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.endswith(_EXTS):
                paths.append(os.path.join(cdir, f))
                labels.append(idx)
    return paths, labels


def _decode_pil(path: str, img_size: int) -> np.ndarray:
    """One image as a normalized (3, img_size, img_size) float32 array."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    resize = int(img_size / 0.875)
    w, h = img.size
    if w < h:
        nw, nh = resize, int(h * resize / w)
    else:
        nw, nh = int(w * resize / h), resize
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - img_size) // 2, (nh - img_size) // 2
    img = img.crop((left, top, left + img_size, top + img_size))
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.transpose(2, 0, 1)  # HWC -> CHW


def iterate_imagenet(root: str, batch_size: int = 100, img_size: int = 224,
                     limit: Optional[int] = None, native: bool = False,
                     num_workers: int = 8,
                     shard: Tuple[int, int] = (0, 1)
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (images (B, 3, H, W) float32, labels (B,) int64).

    shard=(rank, world): each process reads the interleaved shard
    paths[rank::world] (the reference's DistributedSampler without
    shuffling); ``limit`` cuts the shard.  ``native``: the C++ loader, with
    the PIL decode as the fallback (module docstring), which it names on
    stderr."""
    paths, labels = list_imagenet(root)
    rank, world = shard
    paths = paths[rank::world]
    labels = labels[rank::world]
    if limit is not None:
        paths, labels = paths[:limit], labels[:limit]

    if native:
        from ..native import dataloader as nl
        try:
            nl.load()
        except (OSError, RuntimeError) as err:  # no g++, no libjpeg
            print(f"native ImageNet loader unavailable ({err}); decoding "
                  "with PIL", file=sys.stderr)
            native = False
    if native:
        yield from nl.iterate(paths, labels, batch_size, img_size)
        return
    with cf.ThreadPoolExecutor(num_workers) as ex:
        for i in range(0, len(paths), batch_size):
            bp = paths[i:i + batch_size]
            bl = labels[i:i + batch_size]
            imgs = list(ex.map(lambda p: _decode_pil(p, img_size), bp))
            yield (np.stack(imgs), np.asarray(bl, np.int64))
