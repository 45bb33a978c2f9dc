"""Model utilities shared by the port's models (port of the JAX package's
``models/common.py``: the patch embed)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.linear import mm_f32


def patch_embed(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                patch_size: int, bf16: bool = False,
                exact_sum: bool = False) -> torch.Tensor:
    """Non-overlapping patch-embed conv as an im2col matmul.

    (B, C, H, W) x (D, C, p, p) -> (B, N, D) f32, tokens in row-major
    (H/p, W/p) order.  ``bf16=False`` runs the product in full f32 (TF32
    must be off); ``bf16=True`` rounds both operands to bf16 and takes the
    f32 product, like the quantized linears (the serving mode).
    ``exact_sum=True`` takes the f32 operands' products in float64 and
    rounds each sum to f32 once: the correctly rounded f32 conv (up to
    float64's own rounding), whatever order the device sums in."""
    B, C, H, W = x.shape
    D = w.shape[0]
    p = patch_size
    cols = x.reshape(B, C, H // p, p, W // p, p)
    cols = cols.permute(0, 2, 4, 1, 3, 5).reshape(B, -1, C * p * p)
    wm = w.reshape(D, -1)
    if bf16:
        out = mm_f32(cols.to(torch.bfloat16), wm.to(torch.bfloat16))
    elif exact_sum:
        out = torch.matmul(cols.to(torch.float64),
                           wm.to(torch.float64).t()).to(torch.float32)
    else:
        out = torch.matmul(cols.to(torch.float32), wm.to(torch.float32).t())
    return out if b is None else out + b
