"""Exact k-th largest selection without sorting (port of the JAX package's
``ops/selection.py``).

A binary search over the monotonic int32 encoding of float32: 32 count
passes find each row's k-th largest value exactly, ties included.
"""

from __future__ import annotations

import torch

_SIGN = -2147483648  # 0x80000000


def monotonic_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the float order of x (b >= 0 -> b,
    b < 0 -> ~b ^ 0x80000000); -0 maps just below +0 and NaNs beyond the
    infinities, XLA's total order."""
    b = x.to(torch.float32).view(torch.int32)
    return torch.where(b >= 0, b, ~b ^ _SIGN)


def kth_largest_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th largest of int32 keys along the last axis (exact): the
    smallest t with count(keys > t) < k, by a 32-step bisection."""
    shape = keys.shape[:-1]
    lo = torch.full(shape, -2147483648, dtype=torch.int32,
                    device=keys.device)
    hi = torch.full(shape, 2147483647, dtype=torch.int32, device=keys.device)
    for _ in range(32):
        span = hi - lo  # may wrap: read as unsigned, halved logically
        mid = lo + ((span >> 1) & 0x7FFFFFFF)
        cnt = (keys > mid[..., None]).sum(-1, dtype=torch.int32)
        go_up = cnt >= k
        lo = torch.where(go_up, mid + 1, lo)
        hi = torch.where(go_up, hi, mid)
    return lo


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th largest float along the last axis, exact (the value
    ``sort(x)[..., n - k]``)."""
    t = kth_largest_keys(monotonic_keys(x), k)
    back = torch.where(t >= 0, t, ~(t ^ _SIGN))
    return back.view(torch.float32)


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of each row's k largest values along the last axis in
    ``jax.lax.top_k``'s order: descending in XLA's total order (+0 above
    -0), ties lowest index first.  A stable descending sort of the
    monotonic keys (``torch.topk`` leaves the order of ties unspecified,
    and on the card it varies).  k beyond the row raises, as in JAX."""
    if k > x.shape[-1]:
        raise ValueError(f"top-k of k={k} over rows of {x.shape[-1]}")
    keys = monotonic_keys(x)
    return torch.sort(keys, dim=-1, descending=True, stable=True
                      ).indices[..., :k]
