"""Kernel K5: LayerNorm (no affine), adaLN modulate and MX quantize in one
pass (CUDA C++, ``csrc/ln_modulate_quantize.cu``).

Replaces the TPU kernel ``mx_quantization_tpu/ops/kernels/quantize.py``
``ln_modulate_quantize_pallas``: ``quantize_mx(LN(x) * (1 + scale) +
shift)`` along the last axis, the producer-side fusion that feeds the DiT
qkv, fc1 and final linears an activation already on the MX grid (the
consumer then skips its own quantize).  The source's note says what bounds
it and how the design answers.

Numerics (kernel and plain version), per token row of C channels, in f32:
  * mean = k5_row_sum(x) * (1/C) and var = k5_row_sum((x - mean)^2) *
    (1/C), with (1/C) rounded to f32 once and the sums taken in the
    kernel's order (``fastquant.k5_row_sum``: 8-channel chunks as trees,
    a lane's chunks in order, the lanes by an xor butterfly); JAX sums in
    XLA's order, which can move a statistic by an ulp
  * 1 / sqrt(var + eps), each step correctly rounded
  * y = ((x - mean) * rs) * (1 + scale) + shift, every multiply and add
    rounded on its own (the source spells each as a __fmul_rn or
    __fadd_rn, which the compiler never contracts into a fused
    multiply-add)
  * bfloat=16 rounds y half away from zero to bf16, then K1's quantizer
``ln_modulate_quantize`` launches the kernel on a CUDA tensor and raises
where it cannot; only a CPU tensor takes the plain version
``ln_modulate_quantize_ref``.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ...formats import format_params
from ..fastquant import k5_row_sum
from . import build, inference_only
from .quantize import mx_quantize_ref

SOURCE = "ln_modulate_quantize.cu"
# the widest row: JAX's tile rule keeps 64 rows of up to 12288 channels in
# its 12 MB (quantize.py:227-229).  Rows of up to 1280 channels stay in a
# warp's registers; a wider row is kept in shared memory, 4 C bytes a warp
# for f32 input (the source checks that this constant's row fits there)
MAX_CHANNELS = 12288
DEFINES = (("K5_MAX_CHANNELS", MAX_CHANNELS),)


def _inv(C: int) -> float:
    """1/C rounded to f32 (the kernel's and JAX's constant)."""
    return torch.tensor(1.0 / C, dtype=torch.float32).item()


def ln_modulate_quantize_ref(x: torch.Tensor, shift: torch.Tensor,
                             scale: torch.Tensor, elem_format: str = "int8",
                             block_size: int = 32, scale_bits: int = 8,
                             eps: float = 1e-6, out_dtype=torch.bfloat16,
                             flush: bool = False,
                             bfloat: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K5: x (B, N, C), shift and scale (B, C)."""
    B, N, C = x.shape
    if C % 32 or C % block_size:
        raise ValueError(f"C={C} must be a multiple of 32 and of the block "
                         f"({block_size})")
    x32 = x.to(torch.float32)
    inv_c = _inv(C)
    xc = x32 - k5_row_sum(x32) * inv_c
    var = k5_row_sum(xc * xc) * inv_c
    rs = 1.0 / torch.sqrt(var + eps)
    y = (xc * rs) * (1.0 + scale.to(torch.float32)[:, None]) \
        + shift.to(torch.float32)[:, None]
    return mx_quantize_ref(y, elem_format, block_size, scale_bits, out_dtype,
                           flush, 16 if bfloat == 16 else 0)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE, DEFINES)
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.ln_modulate_quantize.argtypes = [p, p, p, p, ctypes.c_longlong, i, i,
                                         i, i, i, i, i, f, f, i, i, i, i, i,
                                         f, i, p]
    lib.ln_modulate_quantize.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy unless its last axis has unit stride and
    its data and rows are 16-byte aligned (the kernel reads 16 bytes at a
    time; the adaLN output's shift and scale chunks already qualify)."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            s * t.element_size() % 16 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def ln_modulate_quantize(x: torch.Tensor, shift: torch.Tensor,
                         scale: torch.Tensor, elem_format: str = "int8",
                         block_size: int = 32, scale_bits: int = 8,
                         eps: float = 1e-6, out_dtype=torch.bfloat16,
                         flush: bool = False,
                         bfloat: int = 0) -> torch.Tensor:
    """quantize_mx(LN(x) * (1 + scale) + shift) along the last axis: x
    (B, N, C) f32 or bf16, shift and scale (B, C) -> (B, N, C).

    K5 on a CUDA tensor; the plain version on a CPU tensor."""
    args = (elem_format, block_size, scale_bits, eps, out_dtype, flush,
            bfloat)
    inference_only("K5 (ln_modulate_quantize)", x, shift, scale)
    if x.device.type == "cpu":
        return ln_modulate_quantize_ref(x, shift, scale, *args)
    if x.device.type != "cuda" or shift.device != x.device or \
            scale.device != x.device:
        raise ValueError("K5 runs on CUDA tensors of one device (or on CPU "
                         f"tensors), not {x.device}, {shift.device}, "
                         f"{scale.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got {tuple(x.shape)}")
    B, N, C = x.shape
    if tuple(shift.shape) != (B, C) or tuple(scale.shape) != (B, C):
        raise ValueError(f"shift and scale must be (B, C) = {(B, C)}, got "
                         f"{tuple(shift.shape)}, {tuple(scale.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 takes float32 or bfloat16 x, not {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 writes float32 or bfloat16, not {out_dtype}")
    if block_size != 32:
        raise NotImplementedError("K5 quantizes in 32-element blocks")
    if C % 32 or C > MAX_CHANNELS:
        raise NotImplementedError(
            f"K5 takes C a multiple of 32 up to MAX_CHANNELS = {MAX_CHANNELS} "
            f"(ops/kernels/ln_modulate_quantize.py), got {C}")
    if not x.is_contiguous():
        raise ValueError("K5 takes a contiguous x")
    out = torch.empty(B, N, C, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    x = _aligned(x)
    if shift.dtype == scale.dtype == torch.bfloat16:
        sh, sc = _aligned(shift), _aligned(scale)
    else:
        sh, sc = (_aligned(t.to(torch.float32)) for t in (shift, scale))
    ebits, mbits, emax, max_norm, _ = format_params(elem_format)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ln_modulate_quantize(
            x.data_ptr(), sh.data_ptr(), sc.data_ptr(), out.data_ptr(), B * N,
            N, C, sh.stride(0), sc.stride(0), int(x.dtype == torch.bfloat16),
            int(sh.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            _inv(C), float(eps), int(bfloat == 16), int(flush), ebits, mbits,
            emax, float(max_norm), scale_bits, stream)
    if err:
        raise RuntimeError(f"K5 launch failed with CUDA error {err}")
    ln_modulate_quantize.launches += 1
    ln_modulate_quantize.sites[(tuple(x.shape), x.dtype, *args)] += 1
    return out


# launches, and launches per call site: (x shape, x dtype, then the
# arguments after scale in order)
ln_modulate_quantize.launches = 0
ln_modulate_quantize.sites = collections.Counter()
