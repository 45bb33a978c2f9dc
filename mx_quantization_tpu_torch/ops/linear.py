"""MX-quantized linear, forward only (port of the JAX package's
``ops/linear.py`` ``linear`` and ``_linear_fwd_fast``).

The quantized product takes bf16 operands (every MX grid point of the
served formats is exact in bf16) and must give the exact f32 product: the
half-away ``bf_fast`` round is applied to the f32 result afterwards.  A bf16
GEMM that writes bf16 would round half to even instead and break ties, so
the card asks cuBLAS for an f32 output (``torch.mm(..., out_dtype=f32)``);
the CPU upcasts both operands to f32, whose products are exact.
"""

from __future__ import annotations

import torch

from ..specs import require_fused
from .fastquant import (bf_fast, fused_eligible, gelu_quantize_serving,
                        quantize_mx_fast, quantize_mx_serving)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (..., K) @ b (N, K).T`` with bf16 operands and an f32 result."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.device.type == "cuda":
        out = torch.mm(a2, b.t(), out_dtype=torch.float32)
    else:
        out = torch.mm(a2.to(torch.float32), b.t().to(torch.float32))
    return out.reshape(*a.shape[:-1], b.shape[0])


def _linear_fwd_fast(x, w, b, specs):
    bs = specs.block_size
    sb = specs.effective_scale_bits()
    fl = specs.mx_flush_fp32_subnorms
    if specs.prequantized_activations:
        qx = bf_fast(x, specs).to(torch.bfloat16)  # already on the MX grid
    else:
        # the bfloat elementwise round rides inside the quantize kernel
        qx = quantize_mx_serving(x, specs.a_elem_format, bs, sb, axis=-1,
                                 flush=fl, bfloat=specs.bfloat)
    if specs.prequantized_weights:
        qw = w.to(torch.bfloat16)  # already on the MX grid
    else:
        qw = quantize_mx_fast(bf_fast(w, specs), specs.w_elem_format, bs,
                              sb, axis=-1, flush=fl)
    out = bf_fast(mm_f32(qx, qw), specs)
    if b is not None:
        out = bf_fast(out + bf_fast(b, specs), specs)
    return out


def linear(x, w, b=None, mx_specs=None):
    """``x @ w.T + b``.  ``mx_specs=None`` runs the unquantized linear in
    full f32 (TF32 must be off, as it is by default) with JAX's output
    dtype; otherwise the fused MX forward."""
    if mx_specs is None:
        out_dtype = torch.result_type(x, w)
        out = torch.matmul(x.to(torch.float32),
                           w.to(torch.float32).t()).to(out_dtype)
        return out if b is None else out + b
    require_fused(mx_specs)
    if not fused_eligible(mx_specs, mx_specs.a_elem_format,
                          mx_specs.w_elem_format):
        raise NotImplementedError(
            "these specs need the emulation engine, which is not ported yet "
            "(ROADMAP.md queue 1)")
    return _linear_fwd_fast(x, w, b, mx_specs)


def gelu_erf(h: torch.Tensor) -> torch.Tensor:
    """The erf-form GELU as ``jax.nn.gelu(approximate=False)`` spells it,
    ``0.5 * h * erfc(-h * sqrt(1/2))`` (``F.gelu`` takes ``erf``, which
    rounds differently)."""
    return 0.5 * h * torch.erfc(-h * 0.7071067811865476)


def gelu_linear(h, w, b, mx_specs, fuse_gelu: bool, contract: str,
                approximate: bool = True):
    """``linear(GELU(h), w, b)``: the MLP's second half in DiT and PixArt
    blocks (tanh form) and DeiT blocks (``approximate=False``: the erf
    form).  With ``fuse_gelu`` in the serving tier the GELU rides in the
    linear's input quantize (``gelu_quantize_serving``, kernel K6) where its
    gate holds, and the linear takes that output as prequantized; else the
    unfused GELU, as the JAX package does."""
    hq = None
    if (fuse_gelu and mx_specs is not None and contract == "serving"
            and not mx_specs.quantize_backprop
            and fused_eligible(mx_specs, mx_specs.a_elem_format,
                               mx_specs.w_elem_format)):
        hq = gelu_quantize_serving(h, mx_specs, approximate=approximate)
    if hq is None:
        g = (torch.nn.functional.gelu(h, approximate="tanh") if approximate
             else gelu_erf(h))
        return linear(g, w, b, mx_specs=mx_specs)
    return linear(hq.to(h.dtype), w, b,
                  mx_specs=mx_specs.replace(prequantized_activations=True))
