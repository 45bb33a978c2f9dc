"""Exact float32 bit manipulation (port of the JAX package's
``ops/bitmath.py``).

The emulation engine quantizes on the integer bit pattern of float32, not
with float arithmetic: XLA's CPU and TPU backends flush subnormals, so the
JAX package works in bits to stay exact, and the port keeps the same
integer arithmetic so that it gives the same bits on the CPU and on the
card (where a float shortcut such as ``ldexp`` or ``frexp`` could round a
subnormal differently).

All functions work elementwise on float32 (``int32`` bit patterns); shift
amounts are clamped to [0, 31] before every shift, and every right shift
here is of a nonnegative value, so torch's arithmetic ``>>`` on int32 is
the logical shift JAX spells ``shift_right_logical``.
"""

from __future__ import annotations

import torch

_SIGN_MASK = -2147483648  # 0x80000000
_EXP_MASK = 0x7F800000
_MANT_MASK = 0x007FFFFF
_IMPLICIT_ONE = 0x00800000


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).view(torch.int32)


def bits_f32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32).view(torch.float32)


def decompose(x: torch.Tensor):
    """-> (sign bit int32, exponent field int32, mantissa int32)."""
    b = f32_bits(x)
    return b & _SIGN_MASK, (b >> 23) & 0xFF, b & _MANT_MASK


def _bit_length_minus_1(m: torch.Tensor) -> torch.Tensor:
    """floor(log2(m)) of int32 m in [1, 2^24): the exponent field of m's
    float32 value, which is exact below 2^24 (``31 - clz(m)``)."""
    return ((m.to(torch.float32).view(torch.int32) >> 23) & 0xFF) - 127


def _shl(a, s):
    return a << s.clamp(0, 31)


def _shr(a, s):
    return a >> s.clamp(0, 31)


def floor_log2_int(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(|x|)) as int32 for finite nonzero x (subnormals
    included); -150 for x == 0."""
    _, e, m = decompose(x)
    # subnormal value = m * 2^-149
    sub_log2 = _bit_length_minus_1(m.clamp(min=1)) - 149
    return torch.where(e > 0, e - 127,
                       torch.where(m == 0, -150, sub_log2))


def _rne_rshift(m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even right shift of nonnegative int32 m by s >= 1
    (clamped at 26)."""
    s = s.clamp(max=26)
    q = _shr(m, s)
    rem = m - _shl(q, s)
    half = _shl(torch.ones_like(m), s - 1)
    round_up = (rem > half) | ((rem == half) & ((q & 1) == 1))
    return q + round_up.to(m.dtype)


def scalbn(x: torch.Tensor, e) -> torch.Tensor:
    """Exact x * 2**e for float32, subnormals kept on both sides.

    Overflow gives +-Inf; a result below 2^-149 rounds to nearest even (as
    an f32 multiply by an exact power of two would); NaN and Inf pass
    through.  Returns float32."""
    x = x.to(torch.float32)
    e = torch.as_tensor(e, dtype=torch.int32, device=x.device)
    sign, E, M = decompose(x)
    nan_inf = E == 255
    zero = (E == 0) & (M == 0)

    m_full = torch.where(E > 0, M | _IMPLICIT_ONE, M)
    ex = torch.where(E > 0, E - 127, -126)
    # normalize so bit 23 is the leading one
    lz = 23 - _bit_length_minus_1(m_full.clamp(min=1))
    m_n = _shl(m_full, lz)
    e_n = ex - lz

    e2 = e_n + e
    overflow = e2 > 127
    normal_bits = sign | ((e2 + 127).clamp(1, 254) << 23) | (m_n & _MANT_MASK)
    # subnormal result: value = m_n * 2^(e2-23) = m_sub * 2^-149
    m_sub = _rne_rshift(m_n, (-126 - e2).clamp(min=1))
    sub_bits = sign | m_sub

    out_bits = torch.where(e2 >= -126, normal_bits, sub_bits)
    out_bits = torch.where(overflow, sign | _EXP_MASK, out_bits)
    out_bits = torch.where(zero, sign, out_bits)
    return torch.where(nan_inf, x, bits_f32(out_bits))


def max_abs_bits(x: torch.Tensor, axis, keepdims: bool = True
                 ) -> torch.Tensor:
    """Exact max(|x|) along ``axis`` as int32 bit patterns: for nonnegative
    float32 the bit pattern is monotonic in the value, and NaN patterns lie
    above Inf, so NaN dominates (torch.max's NaN propagation)."""
    b = f32_bits(x) & 0x7FFFFFFF
    if axis is None:
        return b.amax()
    if isinstance(axis, (list, tuple)):
        axes = sorted((a % x.dim() for a in axis), reverse=True)
        for ax in axes:
            b = b.amax(dim=ax, keepdim=keepdims)
        return b
    return b.amax(dim=axis, keepdim=keepdims)


def bits_floor_log2(b: torch.Tensor) -> torch.Tensor:
    """floor(log2(value)) of a nonnegative value given as its int32 bit
    pattern; -150 for zero."""
    e = (b >> 23) & 0xFF
    m = b & _MANT_MASK
    sub_log2 = _bit_length_minus_1(m.clamp(min=1)) - 149
    return torch.where(e > 0, e - 127, torch.where(m == 0, -150, sub_log2))
