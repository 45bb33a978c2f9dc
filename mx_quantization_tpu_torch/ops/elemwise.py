"""Elementwise (scalar-format) fake quantization of the emulation engine
(port of the JAX package's ``ops/elemwise.py``).

The reference's elementwise quantizer, in integer bit arithmetic
(``ops/bitmath.py``): the private exponent floor(log2|x|) from the exponent
field, the mantissa rounded on the integer significand in the three
reference modes, powers of two applied by ``scalbn``.  Every branch is a
``torch.where`` select, never a min/max clamp on floats, so subnormal
inputs and outputs keep their bits on the CPU and on the card.
``quantize_elemwise_core`` returns float32 whatever it is given, as JAX's
does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..formats import FormatLike, _max_norm, format_params
from .bitmath import (_IMPLICIT_ONE, _shl, _shr, decompose, floor_log2_int,
                      scalbn)


def pow2(e, dtype=torch.float32) -> torch.Tensor:
    """Exact 2**e for integer-valued e (float32, subnormals kept)."""
    e = torch.as_tensor(e, dtype=torch.int32)
    return scalbn(torch.ones((), dtype=dtype, device=e.device), e)


def _round_shift(m: torch.Tensor, s: torch.Tensor, round: str
                 ) -> torch.Tensor:
    """Rounded right shift of the nonnegative 24-bit significand m by
    s >= 1: "nearest" rounds half away from zero, "floor" truncates,
    "even" rounds half to even (the reference CUDA kernel's
    shift_right_round_mantissa)."""
    s = s.clamp(max=27)  # beyond this everything rounds to 0 (m < 2^24)
    q = _shr(m, s)
    if round == "floor":
        return q
    half = _shl(torch.ones_like(m), s - 1)
    rem = m - _shl(q, s)
    if round == "nearest":
        return q + (rem >= half).to(m.dtype)
    if round == "even":
        up = (rem > half) | ((rem == half) & ((q & 1) == 1))
        return q + up.to(m.dtype)
    raise ValueError(f"Unrecognized round method {round!r}")


def quantize_elemwise_core(A, bits: int, exp_bits: int, max_norm: float,
                           round: str = "nearest",
                           saturate_normals: bool = False,
                           allow_denorm: bool = True,
                           flag: bool = False) -> torch.Tensor:
    """Quantize to a float or int grid with ``bits`` mantissa bits (sign and
    implicit one included) and ``exp_bits`` exponent bits (0: a fixed-point
    int grid).

    The private exponent floor(log2|A|) is clipped at the format's minimum
    normal exponent; the mantissa is rounded to the grid
    2**(private_exp - (bits - 2)); overflow clamps to +-max_norm with
    ``saturate_normals`` or an int format, else becomes +-Inf; Inf and NaN
    pass through and zeros map to +0.  ``flag`` is the predict phase:
    values rounded to zero from a nonzero input become +-1e-4 on the scaled
    grid.  Returns float32."""
    A = torch.as_tensor(A).to(torch.float32)
    sign_bits, E, M = decompose(A)
    nan_inf = E == 255
    zero = (E == 0) & (M == 0)
    negative = sign_bits < 0

    m_full = torch.where(E > 0, M | _IMPLICIT_ONE, M)
    ex = torch.where(E > 0, E - 127, -126)  # |A| = m_full * 2^(ex-23)
    flog2 = floor_log2_int(A)

    if exp_bits != 0:
        min_exp = -(2 ** (exp_bits - 1)) + 2
        private_exp = torch.where(zero, 0, flog2).clamp(min=min_exp)
        spacing = private_exp - (bits - 2)
    else:
        spacing = torch.full(A.shape, -(bits - 2), dtype=torch.int32,
                             device=A.device)
    shift = spacing - (ex - 23)  # scaled magnitude = m_full / 2^shift

    # shift >= 1: integer rounding; shift <= 0: an exact power-of-two upscale
    q_right = _round_shift(m_full, shift.clamp(min=1), round).to(
        torch.float32)  # < 2^25, exact
    q_left = scalbn(m_full.to(torch.float32), -shift)
    qf = torch.where(shift >= 1, q_right, q_left)

    if flag:
        qf = torch.where((qf == 0) & ~zero, 1e-4, qf)

    mag = scalbn(qf, spacing)
    out = torch.where(negative, -mag, mag)

    # saturation by select (a float min/max could flush a subnormal operand)
    over = out.abs() > max_norm
    if saturate_normals or exp_bits == 0:
        out = torch.where(over, torch.where(negative, -max_norm, max_norm),
                          out)
    else:
        out = torch.where(over, torch.where(negative, -torch.inf, torch.inf),
                          out)

    if not allow_denorm and exp_bits > 0:
        # flush inputs below the format's min normal, keeping the sign
        emin = 2 - 2 ** (exp_bits - 1)
        flush = (flog2 < emin) & ~zero
        out = torch.where(flush, torch.where(negative, -0.0, 0.0), out)

    out = torch.where(zero, 0.0, out)      # the reference maps -0 to +0
    return torch.where(nan_inf, A, out)


def quantize_elemwise(A, elem_format: FormatLike, round: str = "nearest",
                      saturate_normals: bool = False,
                      allow_denorm: bool = True,
                      predict_phase: bool = False):
    """Quantize to a named element format (reference _quantize_elemwise)."""
    if elem_format is None:
        return A
    ebits, mbits, _, max_norm, _ = format_params(elem_format)
    return quantize_elemwise_core(
        A, mbits, ebits, max_norm, round=round,
        saturate_normals=saturate_normals, allow_denorm=allow_denorm,
        flag=predict_phase)


def quantize_bfloat(A, bfloat: int, round: str = "nearest",
                    allow_denorm: bool = True):
    """Quantize to bfloatX (1 sign + 8 exponent + (X-9) mantissa bits)."""
    if bfloat == 0 or bfloat == 32:
        return A
    return quantize_elemwise_core(A, bits=bfloat - 7, exp_bits=8,
                                  max_norm=_max_norm(8, bfloat - 7),
                                  round=round, allow_denorm=allow_denorm)


def quantize_fp(A, fp: int, round: str = "nearest",
                allow_denorm: bool = True):
    """Quantize to fpX (1 sign + 5 exponent + (X-6) mantissa bits)."""
    if fp == 0:
        return A
    mantissa_bits = fp - 6
    return quantize_elemwise_core(A, bits=mantissa_bits + 2, exp_bits=5,
                                  max_norm=_max_norm(5, mantissa_bits + 2),
                                  round=round, allow_denorm=allow_denorm)


def quantize_elemwise_op(A, mx_specs, round: Optional[str] = None):
    """Spec-driven elementwise quantization (reference
    quantize_elemwise_op).  bfloat=16 with round="even" is the native bf16
    round trip (round to nearest even, kept in A's dtype).  A torch
    sparse-COO tensor has its values quantized and its indices kept."""
    if mx_specs is None:
        return A
    if isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo:
        A = A.coalesce()
        q = quantize_elemwise_op(A.values(), mx_specs, round=round)
        return torch.sparse_coo_tensor(A.indices(), q, A.shape,
                                       is_coalesced=True)
    if round is None:
        round = mx_specs.round

    if mx_specs.bfloat == 16 and round == "even" and mx_specs.bfloat_subnorms:
        return A.to(torch.bfloat16).to(A.dtype)

    if mx_specs.bfloat > 0 and mx_specs.fp > 0:
        raise ValueError("Cannot set both bfloat and fp in mx_specs")
    if mx_specs.bfloat > 9:
        return quantize_bfloat(A, mx_specs.bfloat, round=round,
                               allow_denorm=mx_specs.bfloat_subnorms)
    if mx_specs.fp > 6:
        return quantize_fp(A, mx_specs.fp, round=round,
                           allow_denorm=mx_specs.bfloat_subnorms)
    return A
