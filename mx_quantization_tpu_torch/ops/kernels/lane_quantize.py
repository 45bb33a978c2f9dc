"""Kernel K11: K1's MX quantize with each block maximum taken across a
warp's lanes (CUDA C++, ``csrc/lane_quantize.cu``).

It replaces the TPU kernel ``tools/lanequant_bench.py`` ``mx_quantize_lanes``
(body ``_lane_quant_kernel``, block maximum ``_block_max_bits_lanes``): the
TPU probe that takes the per-block max of |bits| as an XOR butterfly on the
lane axis instead of transposing the blocks onto sublanes.  The max is
exact, so the function is K1's (``quantize.mx_quantize``) bit for bit, and
the plain version is K1's.  ``nomax`` is the probe's ``NOMAX`` diagnostic:
every element is its own block maximum, which gives wrong values on
purpose.  No model path launches it; the port's ``tools/lanequant_bench.py``
does.  The source's note says what bounds it and how the design answers.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ...formats import format_params
from . import BLOCK_SIZES, build
from .quantize import mx_quantize_ref

SOURCE = "lane_quantize.cu"
DTYPES = (torch.float32, torch.bfloat16)


def _check(x, block_size, scale_bits, out_dtype):
    if block_size not in BLOCK_SIZES:
        raise ValueError(f"K11 takes MX blocks {BLOCK_SIZES}, not "
                         f"{block_size}")
    if x.shape[-1] % block_size:
        raise ValueError(f"last axis {x.shape[-1]} is not a multiple of "
                         f"{block_size}")
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"K11 takes and writes float32 or bfloat16, not "
                        f"{x.dtype} -> {out_dtype}")
    if not 1 <= scale_bits <= 16:
        raise ValueError(f"scale_bits must be in 1..16, not {scale_bits}")


def lane_quantize_ref(x: torch.Tensor, elem_format: str = "int8",
                      block_size: int = 32, scale_bits: int = 8,
                      out_dtype=torch.bfloat16, flush: bool = False,
                      bfloat: int = 0, nomax: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K11: K1's plain version (``nomax``: with
    every element its own block)."""
    _check(x, block_size, scale_bits, out_dtype)
    return mx_quantize_ref(x, elem_format, 1 if nomax else block_size,
                           scale_bits, out_dtype, flush, bfloat)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.lane_quantize.argtypes = [p, p, ctypes.c_longlong] + [i] * 6 + \
        [ctypes.c_float] + [i] * 4 + [p]
    lib.lane_quantize.restype = i
    return lib


def lane_quantize(x: torch.Tensor, elem_format: str = "int8",
                  block_size: int = 32, scale_bits: int = 8,
                  out_dtype=torch.bfloat16, flush: bool = False,
                  bfloat: int = 0, nomax: bool = False) -> torch.Tensor:
    """Quantize ``x`` (..., K) along its last axis to the MX grid, each
    block maximum a lane butterfly: K11 on a CUDA tensor, the plain
    version on a CPU tensor.  Raises where the kernel cannot take the
    call."""
    if x.device.type == "cpu":
        return lane_quantize_ref(x, elem_format, block_size, scale_bits,
                                 out_dtype, flush, bfloat, nomax)
    _check(x, block_size, scale_bits, out_dtype)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"K11 takes a contiguous CUDA or CPU tensor, not "
                         f"{x.device}")
    ebits, mbits, emax, max_norm, _ = format_params(elem_format)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _library().lane_quantize(
            x.data_ptr(), out.data_ptr(), x.numel(),
            int(x.dtype == torch.float32), int(out_dtype == torch.float32),
            block_size, ebits, mbits, emax, float(max_norm), scale_bits,
            int(flush), int(bfloat == 16), int(nomax),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K11 launch failed with CUDA error {err}")
    lane_quantize.launches += 1
    lane_quantize.sites[(tuple(x.shape), x.dtype, elem_format, block_size,
                         scale_bits, out_dtype, flush, bfloat, nomax)] += 1
    return out


# launches, and launches per call site: (shape, dtype, then the arguments
# after x in order)
lane_quantize.launches = 0
lane_quantize.sites = collections.Counter()
