"""MX (block floating point, shared-exponent) quantization of the emulation
engine (port of the JAX package's ``ops/mx.py``).

The reference block quantizer, exact in bits:
  * the per-block shared exponent is floor(log2(max|block|)) from the
    integer maximum of the magnitude bits (``bitmath.max_abs_bits``);
  * it is offset by the element format's emax and clamped to the scale
    range: overflow gives a NaN block, underflow -(2**(scale_bits-1)-1);
  * the elements are scaled into the block frame, elementwise-quantized
    with saturation, and scaled back.
One axis is padded to a multiple of block_size and split into
(n_blocks, block_size).  ``mx_encode`` / ``mx_decode`` give the packed form
(int8 mantissas and int8 block exponents).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from ..formats import FP32_EXPONENT_BIAS, FormatLike, format_params
from .bitmath import bits_floor_log2, f32_bits, max_abs_bits, scalbn
from .elemwise import pow2, quantize_elemwise_core

Axis = Union[int, Sequence[int]]


def _single_axis(axes: Axis, ndim: int) -> int:
    if isinstance(axes, (list, tuple)):
        assert len(axes) == 1, (
            "the MX quantizer shares exponents along a single axis (the "
            "reference only ever uses one)")
        axes = axes[0]
    return axes % ndim


def block_view(A: torch.Tensor, axis: int, block_size: int):
    """Pad ``axis`` to a multiple of block_size and split it into
    (n_blocks, block_size).  Returns (blocked, orig_len)."""
    axis = axis % A.dim()
    n = A.shape[axis]
    if block_size <= 0:
        block_size = n
    pad = (-n) % block_size
    if pad:
        widths = [0, 0] * (A.dim() - 1 - axis) + [0, pad]
        A = torch.nn.functional.pad(A, widths)
    nb = (n + pad) // block_size
    return A.reshape(*A.shape[:axis], nb, block_size, *A.shape[axis + 1:]), n


def unblock_view(A: torch.Tensor, axis: int, orig_len: int) -> torch.Tensor:
    """Inverse of block_view: merge (n_blocks, block) and drop padding."""
    axis = axis % (A.dim() - 1)
    A = A.reshape(*A.shape[:axis], A.shape[axis] * A.shape[axis + 1],
                  *A.shape[axis + 2:])
    if A.shape[axis] != orig_len:
        A = A.narrow(axis, 0, orig_len)
    return A


def _shared_exp_bits(A: torch.Tensor, method: str, axes) -> torch.Tensor:
    """Shared-exponent magnitude bits: the exact max(|A|) (or |A| for
    "none") as int32 bit patterns."""
    if method == "max":
        return max_abs_bits(A, axes)
    if method == "none":
        return f32_bits(A) & 0x7FFFFFFF
    raise ValueError(f"Unrecognized shared exponent method {method!r}")


def shared_exponents(A: torch.Tensor, method: str = "max",
                     axes: Optional[Sequence[int]] = None,
                     ebits: int = 0) -> torch.Tensor:
    """Per-block shared exponents as float32 (reference _shared_exponents):
    zeros map to -126, a NaN magnitude to NaN, Inf to +Inf; with ``ebits``
    the exponent is clamped to the format's range (above it NaN)."""
    mb = _shared_exp_bits(A, method, axes)
    exp = bits_floor_log2(mb).to(torch.float32)
    exp = torch.where(mb == 0, float(-(FP32_EXPONENT_BIAS - 1)), exp)
    exp = torch.where(mb > 0x7F800000, torch.nan, exp)
    exp = torch.where(mb == 0x7F800000, torch.inf, exp)
    if ebits > 0:
        emax = 2 ** (ebits - 1) - 1
        exp = torch.where(exp > emax, torch.nan, exp)
        exp = torch.where(exp < -emax, float(-emax), exp)
    return exp


def pow2_f(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e for float e holding small integers; NaN and Inf pass."""
    finite = torch.isfinite(e)
    p = pow2(torch.where(finite, e, 0.0).to(torch.int32))
    return torch.where(finite, p, e)


def quantize_mx(A: torch.Tensor, scale_bits: int, elem_format: FormatLike,
                axes: Axis, block_size: int = 0,
                shared_exp_method: str = "max", round: str = "nearest",
                flush_fp32_subnorms: bool = False,
                predict_phase: bool = False) -> torch.Tensor:
    """Fake-quantize A to an MX format along one axis (reference
    _quantize_mx).  Returns float32."""
    if elem_format is None:
        return A
    assert scale_bits > 0

    axis = _single_axis(axes, A.dim())
    ebits, mbits, emax, max_norm, _ = format_params(elem_format)

    Ab, orig_len = block_view(A, axis, block_size)
    mb = _shared_exp_bits(Ab, shared_exp_method, [axis + 1])
    shared_exp = bits_floor_log2(mb)
    shared_exp = torch.where(mb == 0, -(FP32_EXPONENT_BIAS - 1), shared_exp)
    bad_scale = mb >= 0x7F800000  # an Inf/NaN block max gives a NaN block

    if flush_fp32_subnorms:
        # zero the blocks whose max is an fp32 subnormal, by select
        Ab = torch.where(shared_exp > -FP32_EXPONENT_BIAS, Ab,
                         torch.zeros_like(Ab))

    shared_exp = shared_exp - emax
    scale_emax = 2 ** (scale_bits - 1) - 1
    bad_scale = bad_scale | (shared_exp > scale_emax)  # overflow: NaN block
    shared_exp = shared_exp.clamp(-scale_emax, scale_emax)

    Ab = scalbn(Ab, -shared_exp)
    Ab = quantize_elemwise_core(
        Ab, mbits, ebits, max_norm, round=round, allow_denorm=True,
        saturate_normals=True, flag=predict_phase)
    Ab = scalbn(Ab, shared_exp)
    Ab = torch.where(bad_scale, torch.nan, Ab)
    return unblock_view(Ab, axis, orig_len)


def quantize_mx_op(A: torch.Tensor, mx_specs,
                   elem_format: FormatLike = None,
                   block_size: Optional[int] = None, axes: Axis = None,
                   round: str = "nearest",
                   predict_phase: bool = False) -> torch.Tensor:
    """Spec-driven MX quantization (reference quantize_mx_op)."""
    if elem_format is None:
        return A
    if block_size is None:
        block_size = mx_specs.block_size
    return quantize_mx(
        A, mx_specs.effective_scale_bits(), elem_format, axes=axes,
        block_size=block_size, shared_exp_method=mx_specs.shared_exp_method,
        round=round, flush_fp32_subnorms=mx_specs.mx_flush_fp32_subnorms,
        predict_phase=predict_phase)


class MxPacked(NamedTuple):
    """An MX tensor packed along its last axis.

    mantissa : int8, the (padded) source's shape; for intX formats the grid
               point is mantissa / 2**(mbits-2) * 2**exp.
    exp      : int8 per-block shared exponent (after the emax offset and
               the scale clamp); an overflowed (NaN) block is stored as
               the sentinel +127 and decodes to NaN.
    orig_len : the unpadded length of the last axis."""
    mantissa: torch.Tensor
    exp: torch.Tensor
    orig_len: int
    elem_format: str
    block_size: int


_EXP_NAN_SENTINEL = 127


def mx_encode(A: torch.Tensor, elem_format: FormatLike, block_size: int,
              scale_bits: int = 8, round: str = "nearest",
              flush_fp32_subnorms: bool = False) -> MxPacked:
    """Encode A (last axis blocked) into int8 mantissas and int8 block
    exponents.  Int element formats only (int8/int4/int2)."""
    ebits, mbits, emax, max_norm, _ = format_params(elem_format)
    assert ebits == 0, "packed encoding supports int element formats"

    axis = A.dim() - 1
    Ab, orig_len = block_view(A, axis, block_size)
    mb = _shared_exp_bits(Ab, "max", [axis + 1])
    shared_exp = bits_floor_log2(mb)
    shared_exp = torch.where(mb == 0, -(FP32_EXPONENT_BIAS - 1), shared_exp)
    overflow = mb >= 0x7F800000
    if flush_fp32_subnorms:
        Ab = torch.where(shared_exp > -FP32_EXPONENT_BIAS, Ab,
                         torch.zeros_like(Ab))
    shared_exp = shared_exp - emax
    scale_emax = 2 ** (scale_bits - 1) - 1
    overflow = overflow | (shared_exp > scale_emax)
    shared_exp = shared_exp.clamp(-scale_emax, scale_emax)

    q = quantize_elemwise_core(scalbn(Ab, -shared_exp), mbits, 0, max_norm,
                               round=round, saturate_normals=True)
    mant = torch.round(q * (2 ** (mbits - 2))).to(torch.int8)
    exp_i8 = torch.where(overflow, _EXP_NAN_SENTINEL, shared_exp)
    exp_i8 = exp_i8.squeeze(-1).to(torch.int8)
    name = elem_format if isinstance(elem_format, str) else elem_format.name
    return MxPacked(mant, exp_i8, orig_len, name, block_size)


def mx_decode(p: MxPacked, dtype=torch.float32) -> torch.Tensor:
    """Decode MxPacked back to dense values (each exact in bf16)."""
    _, mbits, _, _, _ = format_params(p.elem_format)
    exp = p.exp.to(torch.int32)[..., None]
    val = p.mantissa.to(dtype) * torch.tensor(2.0 ** -(mbits - 2), dtype=dtype,
                                              device=exp.device)
    out = val * pow2(exp, dtype)
    out = torch.where(exp == _EXP_NAN_SENTINEL,
                      torch.tensor(torch.nan, dtype=out.dtype,
                                   device=out.device), out)
    return unblock_view(out, out.dim() - 2, p.orig_len)
