"""Training augmentations (port of the JAX package's ``data/augment.py``).

Re-implements the reference's 3-Augment (workloads/deit/augment.py, from the
DeiT-III paper): each image gets ONE of {grayscale, solarize, gaussian
blur}, plus random resized crop, horizontal flip and color jitter.  PIL/
numpy host-side (input-pipeline stage, not device code); PIL is imported at
the first call, so the module imports without it.
"""

from __future__ import annotations

import numpy as np

from .imagenet import IMAGENET_MEAN, IMAGENET_STD


def three_augment(img, rng: np.random.RandomState, img_size: int = 224,
                  color_jitter: float = 0.3):
    """img: PIL.Image -> normalized CHW float32 with 3-Augment policy."""
    from PIL import Image, ImageFilter, ImageOps

    # random resized crop (scale 0.08-1.0, timm default)
    w, h = img.size
    for _ in range(10):
        area = w * h * rng.uniform(0.08, 1.0)
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw, ch = int(round(np.sqrt(area * ar))), int(round(np.sqrt(area / ar)))
        if cw <= w and ch <= h:
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            img = img.crop((x0, y0, x0 + cw, y0 + ch))
            break
    img = img.resize((img_size, img_size), Image.BICUBIC)

    if rng.rand() < 0.5:
        img = ImageOps.mirror(img)

    choice = rng.randint(3)
    if choice == 0:
        img = ImageOps.grayscale(img).convert("RGB")
    elif choice == 1:
        img = ImageOps.solarize(img, threshold=128)
    else:
        img = img.filter(ImageFilter.GaussianBlur(
            radius=rng.uniform(0.1, 2.0)))

    if color_jitter:
        from PIL import ImageEnhance
        for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                    ImageEnhance.Color):
            f = 1.0 + rng.uniform(-color_jitter, color_jitter)
            img = enh(img).enhance(f)

    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.transpose(2, 0, 1)
