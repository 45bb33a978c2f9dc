"""Kernels K1 (MX block fake-quantization along the last axis) and K6 (the
same quantize of GELU(x)), both Triton.

K1 replaces the TPU kernel ``mx_quantization_tpu/ops/kernels/quantize.py``
``mx_quantize_pallas`` (body ``_quantize_kernel`` ->
``_quantize_block_values_axis0``, ``_bf16_round_f32``); K6 replaces
``gelu_quantize_pallas`` (body ``_gelu_quantize_kernel``, ``_gelu_f32``),
the producer-side fusion of the MLP activation into the fc2 input quantize.

What bounds them on the card: bytes.  Per element each reads the input once
(2 bytes bf16 or 4 bytes f32) and writes 2 bytes, and does about twenty
integer and float operations (K6 adds a GELU: a tanh or erfc and a few
multiplies), far below the card's operations-per-byte balance.  The design
keeps each to exactly one read and one write: each program loads a
(BLOCK_M, BLOCK_K) tile, reshapes it in registers to (BLOCK_M, BLOCK_K/32,
32), takes the 32-element block maxima of the magnitude bits there, and
stores the quantized tile.  The optional bfloat=16 half-away round (and
K6's GELU) runs on the loaded tile instead of as its own pass.

Arithmetic is the TPU kernels', operation for operation: powers of two are
built from bits (``(e + 127) << 23`` viewed as float32), never with
``exp2``; rounding is ``sign * floor(|s| + 0.5)``; the int grid keeps the
order ``q * scale * (1/half)``.  K6's GELU is f32 in ``jax.nn.gelu``'s
order with libdevice's ``tanh`` and ``erfc`` (the functions torch's CUDA
``tanh`` and ``erfc`` call) and its one multiply-add spelled with the
``_rn`` forms, so it is never contracted.  K1 skips the bfloat=16 round on
a bf16 input (the identity there); K6 rounds its f32 GELU output.  The
plain versions ``mx_quantize_ref`` and ``gelu_quantize_ref`` run the same
arithmetic in torch; the wrappers use them only for a CPU tensor.
"""

from __future__ import annotations

import collections
import functools

import torch

from ...formats import format_params
from ..fastquant import bf16_round_half_away, quantize_blocks
from . import inference_only

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


def _gelu_f32(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU in f32 in ``jax.nn.gelu``'s operation order (the TPU kernel's
    ``_gelu_f32``): tanh form ``x * (0.5 * (1 + tanh(c * (x + 0.044715 *
    x^3))))``, erf form ``0.5 * x * erfc(-x * sqrt(1/2))``; every multiply
    and add rounded on its own.  ``F.gelu`` associates differently."""
    if approximate:
        inner = x + 0.044715 * (x * x * x)
        return x * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * inner)))
    return 0.5 * x * torch.erfc(-x * 0.7071067811865476)


def gelu_quantize_ref(x: torch.Tensor, elem_format: str = "int8",
                      block_size: int = 32, scale_bits: int = 8,
                      out_dtype=torch.bfloat16, flush: bool = False,
                      bfloat: int = 0, approximate: bool = True
                      ) -> torch.Tensor:
    """Plain PyTorch version of K6: K1's quantize of GELU(x) (the bfloat=16
    round applies to the f32 GELU output, whatever x's dtype)."""
    g = _gelu_f32(x.to(torch.float32), approximate)
    return mx_quantize_ref(g, elem_format, block_size, scale_bits, out_dtype,
                           flush, 16 if bfloat == 16 else 0)


@functools.cache
def _triton_kernels():
    """(K1, K6) Triton kernels, compiled at first launch."""
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def quantize_tile(x, BLOCK_M: tl.constexpr, BLOCK_K: tl.constexpr,
                      BS: tl.constexpr, EBITS: tl.constexpr,
                      MBITS: tl.constexpr, EMAX: tl.constexpr,
                      MAX_NORM: tl.constexpr, SCALE_EMAX: tl.constexpr,
                      HALF: tl.constexpr, INV_HALF: tl.constexpr,
                      QMAX: tl.constexpr, MIN_EXP: tl.constexpr,
                      FLUSH: tl.constexpr, BF16_ROUND: tl.constexpr):
        """MX values of an f32 (BLOCK_M, BLOCK_K) tile, blocks of BS along
        its columns."""
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
        return tl.reshape(out, (BLOCK_M, BLOCK_K))

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
        out = quantize_tile(x, BLOCK_M, BLOCK_K, BS, EBITS, MBITS, EMAX,
                            MAX_NORM, SCALE_EMAX, HALF, INV_HALF, QMAX,
                            MIN_EXP, FLUSH, BF16_ROUND)
        tl.store(o_ptr + offs, out.to(o_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def gelu_quantize_kernel(x_ptr, o_ptr, M, K,
                             BLOCK_M: tl.constexpr, BLOCK_K: tl.constexpr,
                             BS: tl.constexpr, EBITS: tl.constexpr,
                             MBITS: tl.constexpr, EMAX: tl.constexpr,
                             MAX_NORM: tl.constexpr, SCALE_EMAX: tl.constexpr,
                             HALF: tl.constexpr, INV_HALF: tl.constexpr,
                             QMAX: tl.constexpr, MIN_EXP: tl.constexpr,
                             FLUSH: tl.constexpr, BF16_ROUND: tl.constexpr,
                             APPROX: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.program_id(1) * BLOCK_K + tl.arange(0, BLOCK_K)
        mask = (rows[:, None] < M) & (cols[None, :] < K)
        offs = rows[:, None].to(tl.int64) * K + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        # GELU in jax.nn.gelu's order; the one multiply-add is spelled
        # with libdevice's _rn forms so that it is never contracted
        if APPROX:
            inner = libdevice.add_rn(x, libdevice.mul_rn(0.044715, x * x * x))
            g = x * (0.5 * (1.0 + libdevice.tanh(0.7978845608028654 * inner)))
        else:
            g = 0.5 * x * libdevice.erfc(-x * 0.7071067811865476)
        out = quantize_tile(g, BLOCK_M, BLOCK_K, BS, EBITS, MBITS, EMAX,
                            MAX_NORM, SCALE_EMAX, HALF, INV_HALF, QMAX,
                            MIN_EXP, FLUSH, BF16_ROUND)
        tl.store(o_ptr + offs, out.to(o_ptr.dtype.element_ty), mask=mask)

    return mx_quantize_kernel, gelu_quantize_kernel


def _check_tile_args(name, x, block_size, out_dtype):
    """The wrapper checks K1 and K6 share; returns (M, K, grid, block_k)."""
    K = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16 input, not "
                        f"{x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} writes float32 or bfloat16, not {out_dtype}")
    if K % block_size or block_size not in (8, 16, 32, 64, 128):
        raise ValueError(f"{name} needs a power-of-two block <= {_BLOCK_K} "
                         f"dividing the last axis (K={K}, "
                         f"block={block_size})")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    M = x.numel() // K
    block_k = min(_BLOCK_K, max(block_size, 1 << (K - 1).bit_length()))
    return M, K, (-(-M // _BLOCK_M), -(-K // block_k)), block_k


def _format_constants(elem_format, block_size, scale_bits, flush):
    ebits, mbits, emax, max_norm, _ = format_params(elem_format)
    return dict(BS=block_size, EBITS=ebits, MBITS=mbits, EMAX=emax,
                MAX_NORM=float(max_norm),
                SCALE_EMAX=2 ** (scale_bits - 1) - 1,
                HALF=float(2 ** (mbits - 2)), INV_HALF=1.0 / 2 ** (mbits - 2),
                QMAX=float(2 ** (mbits - 1) - 1),
                MIN_EXP=2 - 2 ** (ebits - 1) if ebits else 0,
                FLUSH=bool(flush))


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
    M, K, grid, block_k = _check_tile_args("K1", x, block_size, out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    with torch.cuda.device(x.device):
        _triton_kernels()[0][grid](
            x, out, M, K, BLOCK_M=_BLOCK_M, BLOCK_K=block_k,
            BF16_ROUND=bool(bfloat == 16 and x.dtype == torch.float32),
            num_warps=4,
            **_format_constants(elem_format, block_size, scale_bits, flush))
    mx_quantize.launches += 1
    mx_quantize.sites[(tuple(x.shape), x.dtype, elem_format, block_size,
                       scale_bits, out_dtype, flush, bfloat)] += 1
    return out


# launches, and launches per call site: (shape, dtype, then the arguments
# after x in order)
mx_quantize.launches = 0
mx_quantize.sites = collections.Counter()


def gelu_quantize(x: torch.Tensor, elem_format: str = "int8",
                  block_size: int = 32, scale_bits: int = 8,
                  out_dtype=torch.bfloat16, flush: bool = False,
                  bfloat: int = 0, approximate: bool = True) -> torch.Tensor:
    """Quantize GELU(x) (..., K) along its last axis to the MX grid: the
    tanh form (DiT, PixArt) or, with ``approximate=False``, the erf form.

    K6 on a CUDA tensor; the plain version on a CPU tensor."""
    args = (elem_format, block_size, scale_bits, out_dtype, flush, bfloat,
            approximate)
    inference_only("K6 (gelu_quantize)", x)
    if x.device.type == "cpu":
        return gelu_quantize_ref(x, *args)
    M, K, grid, block_k = _check_tile_args("K6", x, block_size, out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    with torch.cuda.device(x.device):
        _triton_kernels()[1][grid](
            x, out, M, K, BLOCK_M=_BLOCK_M, BLOCK_K=block_k,
            BF16_ROUND=bfloat == 16, APPROX=bool(approximate), num_warps=4,
            **_format_constants(elem_format, block_size, scale_bits, flush))
    gelu_quantize.launches += 1
    gelu_quantize.sites[(tuple(x.shape), x.dtype, *args)] += 1
    return out


# launches, and launches per call site: (shape, dtype, then the arguments
# after x in order)
gelu_quantize.launches = 0
gelu_quantize.sites = collections.Counter()
