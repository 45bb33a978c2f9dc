"""Image resize with ``jax.image.resize``'s semantics (the counterpart of
JAX's ``jax.image.resize`` / ``scale_and_translate``, which the JAX
package's VAE, Inception extractor and CLIP preprocessing call).

"nearest" gathers the source index floor((i + 0.5) * in / out), computed in
float32 as JAX computes it.  "bilinear" (the triangle kernel) and "bicubic"
(Keys' cubic with a = -0.5; ``F.interpolate``'s bicubic is a = -0.75, so it
is not used) build, per resized axis, the (in, out) weight matrix that
``jax.image.scale_and_translate`` builds: half-pixel centres, the kernel
widened by in / out when downscaling (``antialias=True``, JAX's default,
always on here), each output's weights renormalized to sum to 1 (so taps
that fall off the edge are dropped), and outputs whose sample point lies
outside the input zeroed.  The weights are computed on the host in
float32 in the operation order of JAX's jitted resize and applied as one
matmul per axis (full f32; TF32 must be off on the card).  Axes whose
size does not change are left as they are, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_F32 = np.float32


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F32(0), _F32(1) - np.abs(x))


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (the f64 product of two f32 values
    is exact), as XLA's fused code computes it."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, as JAX spells it:
    ((1.5 x - 2.5) x) x + 1 below 1, ((-0.5 x + 2.5) x - 4) x + 2 below 2,
    with XLA's multiply-add contractions."""
    out = _fma(_fma(1.5, x, -2.5) * x, x, 1.0)
    far = _fma(_fma(_fma(-0.5, x, 2.5), x, -4.0), x, 2.0)
    out = np.where(x >= 1, far, out)
    return np.where(x >= 2, _F32(0), out).astype(_F32)


def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) float32 resampling weights of one axis, as
    ``jax.image``'s ``compute_weight_mat`` builds them for a plain resize
    (scale out / in, no translation, antialiased)."""
    kernel = {"bilinear": _triangle, "bicubic": _keys_cubic}[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = _F32(max(inv_scale, 1.0))
    # (i + 0.5) * inv_scale - 0.5: one multiply-add in XLA's fused code
    sample_f = _fma(np.arange(out_size, dtype=_F32) + _F32(0.5),
                    _F32(inv_scale), -0.5)
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None])
         / kernel_scale)
    weights = kernel(x)
    total = np.sum(weights, axis=0, keepdims=True, dtype=_F32)
    weights = np.where(
        np.abs(total) > _F32(1000.0 * float(np.finfo(np.float32).eps)),
        weights / np.where(total != 0, total, _F32(1)), _F32(0))
    inside = (sample_f >= -0.5) & (sample_f <= _F32(in_size - 0.5))
    return np.where(inside[None, :], weights, _F32(0)).astype(_F32)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output position of a nearest resize, as JAX's
    ``_resize_nearest`` computes it (float32, then floor)."""
    offsets = ((np.arange(out_size, dtype=_F32) + _F32(0.5)) * _F32(in_size)
               / _F32(out_size))
    return np.floor(offsets.astype(_F32)).astype(np.int64)


def resize(x: torch.Tensor, shape: Sequence[int], method: str
           ) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` (antialiased, JAX's default)
    on ``x``'s device, for ``method`` "nearest", "bilinear" or "bicubic".
    ``shape`` names every axis (batch and channel axes keep their size);
    integer inputs are promoted to float32, as JAX promotes them."""
    if method not in ("nearest", "bilinear", "bicubic"):
        raise ValueError(f'Unknown resize method "{method}"')
    if len(shape) != x.dim():
        raise ValueError("shape must have length equal to the number of "
                         f"dimensions of x; {tuple(shape)} vs "
                         f"{tuple(x.shape)}")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            idx = torch.from_numpy(nearest_indices(m, n)).to(x.device)
            x = x.index_select(d, idx)
            continue
        w = torch.from_numpy(weight_matrix(m, n, method)).to(
            device=x.device, dtype=x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
