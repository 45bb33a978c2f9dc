"""Float-domain MX quantization on integer views of the tensors.

Port of the JAX package's ``ops/fastquant.py``: power-of-two scales are
built from bits (``(e + 127) << 23`` viewed as float32), never with ``exp2``,
and rounding is half away from zero (``sign * floor(|s| + 0.5)``), so the
values match the JAX fast path bit for bit on normal-range inputs.

``quantize_mx_serving`` is the activation quantize in front of every
quantized linear: along a last axis of whole blocks it launches kernel K1
(``kernels/quantize.py``) on a CUDA tensor, and only a CPU tensor takes
K1's plain version; a non-last or ragged axis takes the plain torch chain
on any device, where JAX takes XLA ops.  ``gelu_quantize_serving`` is the serving tier's fused GELU and
fc2-input quantize (kernel K6), under the same rule.
"""

from __future__ import annotations

import torch

from ..formats import format_params

_INT_FMTS = ("int8", "int4", "int2")
_FP_FMTS = ("fp8_e5m2", "fp8_e4m3", "fp6_e3m2", "fp6_e2m3", "fp4_e2m1",
            "fp4")


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e as float32 from the exponent bits (e an int32 tensor)."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def int_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def fused_eligible(specs, *fmts) -> bool:
    """Can these specs take the fast path for the given element formats?"""
    if specs is None or specs.custom_tpu != "fused":
        return False
    if any(f not in _INT_FMTS + _FP_FMTS for f in fmts):
        return False
    return (specs.shared_exp_method == "max"
            and (specs.round_mx_output or "nearest") == "nearest"
            and specs.fp == 0 and specs.bfloat in (0, 16, 32)
            and specs.block_size > 0)


def bf16_round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to the bfloat16 grid half away from zero, as float32.

    bf16 is the top 16 bits of f32: add 0x8000 to the magnitude bits (ties
    carry away from zero, into the exponent where needed) and truncate.
    Inf/NaN pass through.  ``.to(torch.bfloat16)`` rounds half to even and
    differs on ties, which is why this exists.

    On the int32 view the sign bit rides along: adding 0x8000 to the whole
    pattern carries into the sign only from NaN patterns, and an infinity
    maps to itself, so NaN is the one case that needs the original back.
    (Four passes over the tensor; the linears' f32 outputs go through this
    twice each.)"""
    x = x.to(torch.float32)
    r = int_bits(x) + 0x8000
    r &= -65536
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def lane_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a multiple of 32) in the kernels' warp order:
    lane l adds elements l + 32 j in j order, then the 32 lanes add by an
    xor butterfly.  Returns (..., 1)."""
    lanes = e.reshape(*e.shape[:-1], -1, 32)
    acc = lanes[..., 0, :]
    for j in range(1, lanes.shape[-2]):
        acc = acc + lanes[..., j, :]
    w = 16
    while w:
        acc = acc[..., :w] + acc[..., w:2 * w]
        w //= 2
    return acc


def k5_row_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a multiple of 8) in kernel K5's order: the
    axis in 8-element chunks, chunk k on lane k % 32 in round k // 32; each
    chunk's values as the tree ((c0 + c1) + (c2 + c3)) + ((c4 + c5) +
    (c6 + c7)), a lane's chunk sums in round order (the last round padded
    with zeros), then the 32 lanes by ``lane_sum``'s xor butterfly.
    Returns (..., 1)."""
    pad = (-e.shape[-1]) % 256
    if pad:
        e = torch.nn.functional.pad(e, (0, pad))
    c = e.reshape(*e.shape[:-1], -1, 32, 8)
    t = ((c[..., 0] + c[..., 1]) + (c[..., 2] + c[..., 3])) \
        + ((c[..., 4] + c[..., 5]) + (c[..., 6] + c[..., 7]))
    acc = t[..., 0, :]
    for j in range(1, t.shape[-2]):
        acc = acc + t[..., j, :]
    return lane_sum(acc)


def bf_fast(x: torch.Tensor, specs) -> torch.Tensor:
    """Elementwise format: bfloat=16 -> half-away bf16 round (kept in x's
    dtype); bfloat 0/32 -> identity."""
    if specs.bfloat == 16:
        if x.dtype == torch.bfloat16:
            return x  # already on the bf16 grid
        return bf16_round_half_away(x).to(x.dtype)
    return x


def quantize_blocks(xb: torch.Tensor, elem_format, scale_bits: int,
                    flush: bool = False, scale_first: bool = False,
                    nonneg: bool = False):
    """MX-quantize float32 ``xb`` (..., nblocks, block) along its last axis.

    ``elem_format`` is a format name or its ``FormatParams``.

    Returns (values float32, exponents int32 (..., nblocks, 1)).  The
    exponents are the shared exponents for the int grids and the exponents
    of the quantized values for the MXFP grids (the ex_pred operand).

    ``scale_first`` keeps K1's operation order ``q * scale * (1/half)``
    (JAX ``kernels/quantize.py:89``); the default is ``q * (1/half) *
    scale`` (``fastquant.py`` and the attention kernel).  ``nonneg`` is the
    sign-free variant for attention probabilities (``_quant_axis0_pos``).
    The orders agree except where an intermediate overflows.
    """
    ebits, mbits, emax, max_norm, _ = (
        elem_format if isinstance(elem_format, tuple)
        else format_params(elem_format))
    bits = int_bits(xb) & 0x7FFFFFFF
    mb = bits.amax(dim=-1, keepdim=True)
    if flush:
        xb = torch.where(mb >= 0x00800000, xb, torch.zeros_like(xb))
    scale_emax = 2 ** (scale_bits - 1) - 1
    e = ((mb >> 23) - 127 - emax).clamp(-scale_emax, scale_emax)
    inv_scale = pow2(-e)
    scale = pow2(e)
    if ebits == 0:
        half = float(2 ** (mbits - 2))
        qmax = float(2 ** (mbits - 1) - 1)
        scaled = xb * inv_scale * half
        if nonneg:
            q = torch.clamp(torch.floor(scaled + 0.5), max=qmax)
        else:
            q = round_half_away(scaled).clamp(-qmax, qmax)
        if scale_first:
            return q * scale * (1.0 / half), e
        return q * (1.0 / half) * scale, e

    scaled = xb * inv_scale
    min_exp = -(2 ** (ebits - 1)) + 2
    sb = int_bits(scaled) & 0x7FFFFFFF
    pe = torch.clamp((sb >> 23) - 127, min=min_exp)
    sp_e = (pe - (mbits - 2)).clamp(-126, 127)
    sm = scaled * pow2(-sp_e)
    q = torch.floor(sm + 0.5) if nonneg else round_half_away(sm)
    out = (q * pow2(sp_e)).clamp(-max_norm, max_norm) * scale
    ob = int_bits(out) & 0x7FFFFFFF
    return out, (ob.amax(dim=-1, keepdim=True) >> 23) - 127


def quantize_mx_fast(x: torch.Tensor, elem_format: str, block_size: int,
                     scale_bits: int = 8, axis: int = -1,
                     out_dtype=torch.bfloat16,
                     flush: bool = False) -> torch.Tensor:
    """MX fake-quantize along ``axis`` (ragged tails padded with zeros)."""
    axis = axis % x.ndim
    xm = x.to(torch.float32).movedim(axis, -1)
    n = xm.shape[-1]
    pad = (-n) % block_size
    if pad:
        xm = torch.nn.functional.pad(xm, (0, pad))
    xb = xm.reshape(*xm.shape[:-1], -1, block_size)
    out, _ = quantize_blocks(xb, elem_format, scale_bits, flush)
    out = out.reshape(xm.shape)[..., :n].to(out_dtype)
    return out.movedim(-1, axis).contiguous()


def quantize_mx_serving(x: torch.Tensor, elem_format: str, block_size: int,
                        scale_bits: int = 8, axis: int = -1,
                        out_dtype=torch.bfloat16, flush: bool = False,
                        bfloat: int = 0) -> torch.Tensor:
    """Activation MX quantize with the bfloat round fused in.

    Last axis and whole blocks: kernel K1 on a CUDA tensor, its plain
    version on a CPU tensor.  A non-last or ragged axis takes the plain
    torch chain on any device, as JAX takes its XLA ops there."""
    axis = axis % x.ndim
    if axis == x.ndim - 1 and x.shape[axis] % block_size == 0:
        from .kernels.quantize import mx_quantize
        return mx_quantize(x, elem_format, block_size, scale_bits,
                           out_dtype=out_dtype, flush=flush, bfloat=bfloat)
    if bfloat == 16 and x.dtype != torch.bfloat16:
        x = bf16_round_half_away(x)
    return quantize_mx_fast(x, elem_format, block_size, scale_bits,
                            axis=axis, out_dtype=out_dtype, flush=flush)


def gelu_quantize_serving(x: torch.Tensor, specs, approximate: bool = True):
    """Fused GELU + MX quantize of the fc2 input (serving tier).

    Returns the MX-grid fc2 operand in bf16 where the one-pass kernel
    applies (last axis block-aligned, at least 2^16 elements, on the card:
    kernel K6; on the CPU: its plain version), or None: the caller keeps the
    unfused GELU and quantize, as the JAX package does off those
    conditions."""
    bs = specs.block_size
    if not (x.shape[-1] % bs == 0 and x.numel() >= (1 << 16)
            and x.device.type in ("cuda", "cpu")):
        return None
    from .kernels.quantize import gelu_quantize
    return gelu_quantize(x, specs.a_elem_format, bs,
                         specs.effective_scale_bits(),
                         flush=specs.mx_flush_fp32_subnorms,
                         bfloat=specs.bfloat, approximate=approximate)
