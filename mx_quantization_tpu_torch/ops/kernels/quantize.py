"""Kernel K1: MX block fake-quantization along the last axis (Triton).

Replaces the TPU kernel ``mx_quantization_tpu/ops/kernels/quantize.py``
``mx_quantize_pallas`` (body ``_quantize_kernel`` ->
``_quantize_block_values_axis0``, ``_bf16_round_f32``).

What bounds it on the card: bytes.  Per element it reads the input once
(2 bytes bf16 or 4 bytes f32) and writes 2 bytes, and does about twenty
integer and float operations, far below the card's operations-per-byte
balance.  The design keeps it to exactly one read and one write: each
program loads a (BLOCK_M, BLOCK_K) tile, reshapes it in registers to
(BLOCK_M, BLOCK_K/32, 32), takes the 32-element block maxima of the
magnitude bits there, and stores the quantized tile.  The optional bfloat=16
half-away round runs on the loaded tile instead of as its own pass.

Arithmetic is the TPU kernel's, operation for operation: powers of two are
built from bits (``(e + 127) << 23`` viewed as float32), never with
``exp2``; rounding is ``sign * floor(|s| + 0.5)``; the int grid keeps the
order ``q * scale * (1/half)``.  The plain version ``mx_quantize_ref`` runs
the same arithmetic in torch; the wrapper uses it only for a CPU tensor.
"""

from __future__ import annotations

import collections
import functools

import torch

from ...formats import format_params
from ..fastquant import bf16_round_half_away, quantize_blocks

_BLOCK_M = 32
_BLOCK_K = 128


def mx_quantize_ref(x: torch.Tensor, elem_format: str = "int8",
                    block_size: int = 32, scale_bits: int = 8,
                    out_dtype=torch.bfloat16, flush: bool = False,
                    bfloat: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arithmetic, same order)."""
    K = x.shape[-1]
    if K % block_size:
        raise ValueError(f"last axis {K} is not a multiple of {block_size}")
    x32 = x.to(torch.float32)
    if bfloat == 16 and x.dtype != torch.bfloat16:
        x32 = bf16_round_half_away(x32)
    xb = x32.reshape(*x.shape[:-1], K // block_size, block_size)
    out, _ = quantize_blocks(xb, elem_format, scale_bits, flush,
                             scale_first=True)
    return out.reshape(x.shape).to(out_dtype)


@functools.cache
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def mx_quantize_kernel(x_ptr, o_ptr, M, K,
                           BLOCK_M: tl.constexpr, BLOCK_K: tl.constexpr,
                           BS: tl.constexpr, EBITS: tl.constexpr,
                           MBITS: tl.constexpr, EMAX: tl.constexpr,
                           MAX_NORM: tl.constexpr, SCALE_EMAX: tl.constexpr,
                           HALF: tl.constexpr, INV_HALF: tl.constexpr,
                           QMAX: tl.constexpr, MIN_EXP: tl.constexpr,
                           FLUSH: tl.constexpr, BF16_ROUND: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.program_id(1) * BLOCK_K + tl.arange(0, BLOCK_K)
        mask = (rows[:, None] < M) & (cols[None, :] < K)
        offs = rows[:, None].to(tl.int64) * K + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if BF16_ROUND:
            # half-away bf16 round: +0x8000 on the magnitude bits, truncate
            b = x.to(tl.int32, bitcast=True)
            mag = b & 0x7FFFFFFF
            rounded = (mag + 0x8000) & -65536
            mag = tl.where(mag >= 0x7F800000, mag, rounded)
            x = (mag | (b & -2147483648)).to(tl.float32, bitcast=True)
        xb = tl.reshape(x, (BLOCK_M, BLOCK_K // BS, BS))
        bits = xb.to(tl.int32, bitcast=True) & 0x7FFFFFFF
        mb = tl.max(bits, axis=2)[:, :, None]
        if FLUSH:
            xb = tl.where(mb >= 0x00800000, xb, 0.0)
        e = (mb >> 23) - 127 - EMAX
        e = tl.minimum(tl.maximum(e, -SCALE_EMAX), SCALE_EMAX)
        inv_scale = ((127 - e) << 23).to(tl.float32, bitcast=True)
        scale = ((e + 127) << 23).to(tl.float32, bitcast=True)
        if EBITS == 0:
            s = xb * inv_scale * HALF
            q = tl.floor(tl.abs(s) + 0.5)
            q = tl.where(s < 0, -q, q)
            q = tl.minimum(tl.maximum(q, -QMAX), QMAX)
            out = q * scale * INV_HALF
        else:
            s = xb * inv_scale
            sb = s.to(tl.int32, bitcast=True) & 0x7FFFFFFF
            pe = tl.maximum((sb >> 23) - 127, MIN_EXP)
            sp_e = tl.minimum(tl.maximum(pe - (MBITS - 2), -126), 127)
            spacing = ((sp_e + 127) << 23).to(tl.float32, bitcast=True)
            inv_spacing = ((127 - sp_e) << 23).to(tl.float32, bitcast=True)
            sm = s * inv_spacing
            q = tl.floor(tl.abs(sm) + 0.5)
            q = tl.where(sm < 0, -q, q)
            out = tl.minimum(tl.maximum(q * spacing, -MAX_NORM), MAX_NORM)
            out = out * scale
        out = tl.reshape(out, (BLOCK_M, BLOCK_K))
        tl.store(o_ptr + offs, out.to(o_ptr.dtype.element_ty), mask=mask)

    return mx_quantize_kernel


def mx_quantize(x: torch.Tensor, elem_format: str = "int8",
                block_size: int = 32, scale_bits: int = 8,
                out_dtype=torch.bfloat16, flush: bool = False,
                bfloat: int = 0) -> torch.Tensor:
    """Quantize ``x`` (..., K) along its last axis to the MX grid (values).

    K1 on a CUDA tensor; the plain version on a CPU tensor.  bfloat=16
    rounds an f32 input to the bf16 grid half away from zero first (a bf16
    input already sits there, so the round is skipped)."""
    if x.device.type == "cpu":
        return mx_quantize_ref(x, elem_format, block_size, scale_bits,
                               out_dtype, flush, bfloat)
    K = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes float32 or bfloat16 input, not {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 writes float32 or bfloat16, not {out_dtype}")
    if K % block_size or block_size not in (8, 16, 32, 64, 128):
        raise ValueError(f"K1 needs a power-of-two block <= {_BLOCK_K} "
                         f"dividing the last axis (K={K}, "
                         f"block={block_size})")
    if not x.is_contiguous():
        raise ValueError("K1 takes a contiguous tensor")
    M = x.numel() // K
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    block_k = min(_BLOCK_K, max(block_size, 1 << (K - 1).bit_length()))
    grid = (-(-M // _BLOCK_M), -(-K // block_k))
    ebits, mbits, emax, max_norm, _ = format_params(elem_format)
    with torch.cuda.device(x.device):
        _triton_kernel()[grid](
            x, out, M, K, BLOCK_M=_BLOCK_M, BLOCK_K=block_k, BS=block_size,
            EBITS=ebits, MBITS=mbits, EMAX=emax, MAX_NORM=float(max_norm),
            SCALE_EMAX=2 ** (scale_bits - 1) - 1,
            HALF=float(2 ** (mbits - 2)), INV_HALF=1.0 / 2 ** (mbits - 2),
            QMAX=float(2 ** (mbits - 1) - 1),
            MIN_EXP=2 - 2 ** (ebits - 1) if ebits else 0,
            FLUSH=bool(flush),
            BF16_ROUND=bool(bfloat == 16 and x.dtype == torch.float32),
            num_warps=4)
    mx_quantize.launches += 1
    mx_quantize.sites[(tuple(x.shape), x.dtype, elem_format, block_size,
                       scale_bits, out_dtype, flush, bfloat)] += 1
    return out


# launches, and launches per call site: (shape, dtype, then the arguments
# after x in order)
mx_quantize.launches = 0
mx_quantize.sites = collections.Counter()
