"""Kernel K9: the fused MX matmul C = Q(A) Q(B) in f32 (CUDA C++,
``csrc/mx_matmul_ablation.cu``).

It replaces the TPU kernel ``tools/mx_matmul_ablation.py``
``mx_matmul_pallas`` (body ``_mm_kernel``), the retired ablation that
quantizes A (M, K) and B (K, N) along K inside the product.  Q is the TPU
kernel's ``_quantize_block_values_axis0`` as ``_mm_kernel`` calls it: only
the format's mbits is passed, so every format lands on an integer grid
(ebits = emax = 0; fp8_e4m3 on a 5-bit integer grid, not MXFP8's), the
values are cast to bf16 (round to nearest even: float16's codes, up to
2047, round there), and a block whose maximum is f32-subnormal has scale 0.
The product sums each pair of MX blocks exactly, rounds that sum to f32
once, and adds the blocks in K order in f32 from +0; the TPU kernel sums in
the MXU's order over a 512-wide K tile, so the two agree bit for bit at one
block and within ``summation_bound`` beyond.  Inputs are finite and below
2^117 in magnitude: above, the TPU kernel's q 2^e (before its 1/half) can
overflow to inf, which the kernel's integer codes do not follow.  No model
path launches it; the port's ``tools/mx_matmul_ablation.py`` does.  The
source's note says what bounds it and how the design answers.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ...formats import FormatParams, format_params
from ..fastquant import quantize_blocks
from . import BLOCK_SIZES, build

SOURCE = "mx_matmul_ablation.cu"


def _mbits(elem_format: str) -> int:
    return format_params(elem_format).mbits


def _check(a, b, block_size, scale_bits):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"K9 takes A (M, K) and B (K, N), not "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if block_size not in BLOCK_SIZES:
        raise ValueError(f"K9 takes MX blocks {BLOCK_SIZES}, not "
                         f"{block_size}")
    if a.shape[1] % block_size:
        raise ValueError(f"K = {a.shape[1]} is not a multiple of the block "
                         f"{block_size}")
    if not 1 <= scale_bits <= 16:
        raise ValueError(f"scale_bits must be in 1..16, not {scale_bits}")


def quantize_k(x: torch.Tensor, elem_format: str, block_size: int,
               scale_bits: int, axis: int) -> torch.Tensor:
    """Q along ``axis`` of 2-d ``x`` as the TPU kernel's ``_mm_kernel``
    spells it: the integer grid of the format's mbits, the int grid's
    ``q * scale * (1/half)``, cast to bf16."""
    xt = x.to(torch.float32).movedim(axis, -1)
    xb = xt.reshape(*xt.shape[:-1], -1, block_size)
    grid = FormatParams(0, _mbits(elem_format), 0, 0.0, 0.0)
    out, _ = quantize_blocks(xb, grid, scale_bits, scale_first=True)
    return out.reshape(xt.shape).movedim(-1, axis).to(torch.bfloat16)


def quantize_operands(a, b, elem_format_a="int8", elem_format_b="int8",
                      block_size=32, scale_bits=8):
    """(Q(A), Q(B)) bf16, A (M, K) and B (K, N) each along K."""
    return (quantize_k(a, elem_format_a, block_size, scale_bits, 1),
            quantize_k(b, elem_format_b, block_size, scale_bits, 0))


def summation_bound(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """K 2^-24 sum_k |Q(A)_ik Q(B)_kj|: how far two orders of f32
    summation of the same products may differ, at most."""
    prod = qa.to(torch.float64).abs() @ qb.to(torch.float64).abs()
    return (qa.shape[1] * 2.0 ** -24 * prod).to(torch.float32)


def mx_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                  elem_format_a: str = "int8", elem_format_b: str = "int8",
                  block_size: int = 32, scale_bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K9: Q(A) and Q(B), then per MX block a
    float64 product (exact: the codes' sums stay below 2^53), rounded to
    f32 and added in K order from +0.  It never holds the (blocks, M, N)
    partial products."""
    _check(a, b, block_size, scale_bits)
    qa, qb = quantize_operands(a, b, elem_format_a, elem_format_b,
                               block_size, scale_bits)
    qa, qb = qa.to(torch.float64), qb.to(torch.float64)
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], block_size):
        blk = slice(k0, k0 + block_size)
        out += (qa[:, blk] @ qb[blk]).to(torch.float32)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.mx_matmul.argtypes = [p, p, p] + [i] * 7 + [p]
    lib.mx_matmul.restype = i
    return lib


def mx_matmul(a: torch.Tensor, b: torch.Tensor, elem_format_a: str = "int8",
              elem_format_b: str = "int8", block_size: int = 32,
              scale_bits: int = 8) -> torch.Tensor:
    """(M, K) x (K, N) -> (M, N) f32, both operands MX-quantized along K:
    K9 on CUDA tensors, the plain version on CPU tensors.  Raises where
    the kernel cannot take the call."""
    if a.device.type == "cpu":
        return mx_matmul_ref(a, b, elem_format_a, elem_format_b, block_size,
                             scale_bits)
    _check(a, b, block_size, scale_bits)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"K9 runs on CUDA tensors of one device (or on CPU "
                         f"tensors), not {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32 or \
            not (a.is_contiguous() and b.is_contiguous()):
        raise TypeError("K9 takes contiguous float32 A and B, as the TPU "
                        "kernel casts them")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    with torch.cuda.device(a.device):
        err = _library().mx_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, block_size,
            _mbits(elem_format_a), _mbits(elem_format_b), scale_bits,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K9 launch failed with CUDA error {err}")
    mx_matmul.launches += 1
    mx_matmul.sites[((M, K, N), elem_format_a, elem_format_b, block_size,
                     scale_bits)] += 1
    return out


# launches, and launches per call site: ((M, K, N), then the arguments
# after b in order)
mx_matmul.launches = 0
mx_matmul.sites = collections.Counter()
