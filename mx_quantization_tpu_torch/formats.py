"""Element format definitions for MX (OCP Microscaling) quantization.

Plain Python, no tensor library: the same format table as the JAX package's
``formats.py``, kept as the port's own copy.

A format is described by:
  ebits    : exponent bits (0 for ints)
  mbits    : mantissa bits INCLUDING the sign bit and the implicit leading one
  emax     : maximum normal exponent
  max_norm : largest representable magnitude
  min_norm : smallest normal magnitude (0 for ints)

``intX`` is a sign-magnitude fixed point grid with a "1.xxx" radix: points
are i / 2**(X-2) for |i| <= 2**(X-1)-1 (int8's max_norm is 127/64).
``fp8_e4m3`` has no Inf and uses the top exponent for large normals, giving
max_norm = 2**emax * 1.75.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Union

FP32_EXPONENT_BIAS = 127


class ElemFormat(enum.Enum):
    int8 = 1
    int4 = 2
    int2 = 3
    fp8_e5m2 = 4
    fp8_e4m3 = 5
    fp6_e3m2 = 6
    fp6_e2m3 = 7
    fp4 = 8
    fp4_e2m1 = 8
    float16 = 9
    fp16 = 9
    bfloat16 = 10
    bf16 = 10

    @staticmethod
    def from_str(s: str) -> "ElemFormat":
        if s is None:
            raise ValueError("elem_format string is None")
        s = s.lower()
        if hasattr(ElemFormat, s):
            return getattr(ElemFormat, s)
        raise ValueError(f"Undefined elem format: {s!r}")


FormatLike = Union[str, ElemFormat, None]


class FormatParams(NamedTuple):
    ebits: int
    mbits: int
    emax: int
    max_norm: float
    min_norm: float


def _min_norm(ebits: int) -> float:
    """Smallest normal for a float format; 0 for ints (ebits == 0)."""
    if ebits == 0:
        return 0.0
    emin = 2 - (2 ** (ebits - 1))
    return 2.0 ** emin


def _max_norm(ebits: int, mbits: int) -> float:
    """Largest normal for float formats that reserve the top exponent for
    NaN/Inf (the bfloatX and fpX elementwise grids)."""
    assert ebits >= 5, "only valid for formats that define NaN/Inf"
    emax = 0 if ebits == 0 else 2 ** (ebits - 1) - 1
    return 2 ** emax * float(2 ** (mbits - 1) - 1) / 2 ** (mbits - 2)


# (ebits, mbits, emax) per format; max_norm/min_norm derived below.
_FORMAT_TABLE = {
    ElemFormat.int8: (0, 8, 0),
    ElemFormat.int4: (0, 4, 0),
    ElemFormat.int2: (0, 2, 0),
    ElemFormat.fp8_e5m2: (5, 4, 15),
    ElemFormat.fp8_e4m3: (4, 5, 8),
    ElemFormat.fp6_e3m2: (3, 4, 4),
    ElemFormat.fp6_e2m3: (2, 5, 2),
    ElemFormat.fp4: (2, 3, 2),
    ElemFormat.float16: (5, 12, 15),
    ElemFormat.bfloat16: (8, 9, 127),
}


def format_params(fmt: FormatLike) -> FormatParams:
    """Return (ebits, mbits, emax, max_norm, min_norm) for a format."""
    if isinstance(fmt, str):
        fmt = ElemFormat.from_str(fmt)
    if fmt not in _FORMAT_TABLE:
        raise ValueError(f"Unknown element format {fmt}")
    ebits, mbits, emax = _FORMAT_TABLE[fmt]
    if fmt is ElemFormat.fp8_e4m3:
        max_norm = 2 ** emax * 1.75  # e4m3 has no Inf: extended max normal
    else:
        max_norm = 2 ** emax * float(2 ** (mbits - 1) - 1) / 2 ** (mbits - 2)
    min_norm = _min_norm(ebits)
    return FormatParams(ebits, mbits, emax, max_norm, min_norm)
