"""Kernel K2: fused MX top-k self-attention from the fused qkv output.

The CUDA source is ``csrc/topk_attention_qkv.cu`` (it replaces the TPU
kernel ``mx_quantization_tpu/ops/kernels/topk_attention.py``
``fused_topk_attention_qkv``; the source's note says what bounds it and
how the design answers).  ``fused_topk_attention_qkv`` launches it on a
CUDA tensor and raises where it cannot; only a CPU tensor takes the plain
version ``fused_topk_attention_qkv_ref``.

Numerics (both the kernel and the plain version), per (batch row, head):
  * q and k MX-quantized along D (zero-padded to the block), v along N in
    32-token blocks per column; an f32 input at bfloat=16 is first rounded
    to bf16 half away from zero
  * true scores: f32 sums of the (bf16-exact) products in d order; the
    exact tier rounds them half away to bf16 (bfloat=16), then scales
  * ex_pred scores: sign * 2^(block exponent) operands (zeros count as +,
    padded d masked), summed per block and the blocks in order
  * monotone keys truncated to key_bits; the k-th key by bisection with the
    count of greater keys carried; exact tier: greater keys plus ties
    lowest index first up to k; serving tier: every key >= the k-th; dense
    (k >= N): every valid key
  * masked softmax (the softmax sum adds keys s = l + 32 j per lane l in j
    order, then the 32 lanes by an xor butterfly, as the kernel's warp does)
  * exact tier: attn rounded half away to bf16 (bfloat=16) and MX-quantized
    along the keys with the sign-free quantizer; serving: RNE cast to bf16
  * PV summed in key order; the exact tier rounds it half away to bf16;
    the cast to ``out_dtype`` is RNE
Keys and tokens are zero-padded to a multiple of 32 and masked; the TPU
kernel pads to 128, which leaves every value unchanged.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ...formats import FormatParams
from ..fastquant import bf16_round_half_away, pow2, quantize_blocks
from . import build

SOURCE = "topk_attention_qkv.cu"
# the longest sequence the kernel holds in shared memory: kMaxNj * 32 in
# the source, whose launcher refuses anything larger
MAX_TOKENS = 256
_NEG = -3.0e38


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_args(pred_mode, approx, contract, key_bits, block_size):
    if approx and pred_mode != "ex_pred":
        raise NotImplementedError(
            f"pred_mode={pred_mode!r}: the port's qkv kernel serves ex_pred "
            "only; the other predictors come with kernel K3 (ROADMAP.md)")
    if contract not in ("exact", "serving"):
        raise ValueError(f"unknown contract {contract!r}")
    if key_bits not in (8, 16, 32):
        raise ValueError(f"key_bits must be 8, 16 or 32, not {key_bits}")
    if block_size != 32:
        raise NotImplementedError("K2 quantizes in 32-element blocks")


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------
def _mono_keys(x: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Monotone int64 keys of f32 scores, truncated to key_bits."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    if key_bits == 32:
        return torch.where(b >= 0, b, (-b - 1) ^ -2147483648)
    shift = 32 - key_bits
    h = b >> shift
    return torch.where(h >= 0, h, (-(1 << (31 - shift)) - 1) - h)


def _kth_keys(keys: torch.Tensor, k: int, key_bits: int):
    """Per-row k-th largest key by bisection: (kth, count of keys > kth)."""
    lo_init, hi_init = -(1 << (key_bits - 1)), (1 << (key_bits - 1)) - 1
    shape = keys.shape[:-1] + (1,)
    lo = torch.full(shape, lo_init, dtype=torch.int64, device=keys.device)
    hi = torch.full(shape, hi_init, dtype=torch.int64, device=keys.device)
    cnt_hi = torch.zeros(shape, dtype=torch.int64, device=keys.device)
    for _ in range(key_bits):
        mid = lo + ((hi - lo) >> 1)
        cnt = (keys > mid).sum(-1, keepdim=True)
        up = cnt >= k
        lo = torch.where(up, mid + 1, lo)
        hi = torch.where(up, hi, mid)
        cnt_hi = torch.where(up, cnt_hi, cnt)
    return lo, cnt_hi


def _lane_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's warp order."""
    lanes = e.reshape(*e.shape[:-1], -1, 32)
    acc = lanes[..., 0, :]
    for j in range(1, lanes.shape[-2]):
        acc = acc + lanes[..., j, :]
    w = 16
    while w:
        acc = acc[..., :w] + acc[..., w:2 * w]
        w //= 2
    return acc


def _dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, P) in f32, the products added in K order
    as the kernel's multiply-add loop does (the operands are bf16-exact, so
    every product is exact and only the order rounds)."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1], device=a.device)
    for i in range(a.shape[-1]):
        out = out + a[..., :, i, None] * b[..., None, i, :]
    return out


def fused_topk_attention_qkv_ref(qkv: torch.Tensor, num_heads: int, *,
                                 k: int, scale: float, block_size: int = 32,
                                 mbits: int = 8, scale_bits: int = 8,
                                 approx: bool = True,
                                 pred_mode: str = "ex_pred",
                                 key_bits: int = 32,
                                 out_dtype=torch.float32, bfloat: int = 0,
                                 flush: bool = False, ebits: int = 0,
                                 emax: int = 0, max_norm: float = 0.0,
                                 contract: str = "exact") -> torch.Tensor:
    """Plain PyTorch version of K2, vectorized over (batch, head)."""
    _check_args(pred_mode, approx, contract, key_bits, block_size)
    relaxed = contract == "serving"
    fmt = FormatParams(ebits, mbits, emax, max_norm, 0.0)
    B, N, F = qkv.shape
    H = num_heads
    D = F // (3 * H)
    Np = _round_up(N, 32)
    Dp = _round_up(max(D, 8), 32)
    nb = Dp // 32

    x = qkv.to(torch.float32)
    if bfloat == 16 and qkv.dtype != torch.bfloat16:
        x = bf16_round_half_away(x)
    x = x.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)  # (3, B, H, N, D)
    x = torch.nn.functional.pad(x, (0, Dp - D, 0, Np - N))
    blocks = x[:2].reshape(2, B, H, Np, nb, 32)
    qk, e = quantize_blocks(blocks, fmt, scale_bits, flush)
    q, kq = qk[0].reshape(B, H, Np, Dp), qk[1].reshape(B, H, Np, Dp)
    vt = x[2, ..., :D].transpose(-1, -2).reshape(B, H, D, Np // 32, 32)
    v, _ = quantize_blocks(vt, fmt, scale_bits, flush)
    v = v.reshape(B, H, D, Np).transpose(-1, -2)  # (B, H, Np, D)

    st = _dot_in_order(q[..., :D], kq[..., :D].transpose(-1, -2))
    if bfloat == 16 and not relaxed:
        st = bf16_round_half_away(st)
    st = st * scale

    valid = torch.arange(Np, device=qkv.device) < N
    if k >= N:
        sel = valid.expand(B, H, Np, Np)
    else:
        if approx:
            # ex_pred operands +-2^e (zeros count as +), padded d masked;
            # every per-block sum is exact, the blocks add in order
            pw = pow2(e.clamp(-126, 127))
            a = torch.where(qk < 0, -pw, pw)
            a = a * (torch.arange(Dp, device=qkv.device) < D
                     ).reshape(nb, 32).to(a.dtype)
            blk = torch.einsum("bhnkd,bhskd->bhnsk", a[0], a[1])
            s_sel = blk[..., 0]
            for i in range(1, nb):
                s_sel = s_sel + blk[..., i]
        else:
            s_sel = st
        s_sel = torch.where(valid, s_sel, _NEG)
        keys = _mono_keys(s_sel, key_bits)
        kth, n_gt = _kth_keys(keys, k, key_bits)
        if relaxed:
            sel = keys >= kth
        else:
            eq = keys == kth
            rank = torch.cumsum(eq.to(torch.int64), dim=-1)
            sel = (keys > kth) | (eq & (rank <= k - n_gt))

    masked = torch.where(sel, st, _NEG)
    ex = torch.exp(masked - masked.amax(-1, keepdim=True))
    attn = ex / _lane_sum(ex)
    if relaxed:
        attn = attn.to(torch.bfloat16).to(torch.float32)
    else:
        if bfloat == 16:
            attn = bf16_round_half_away(attn)
        attn, _ = quantize_blocks(attn.reshape(B, H, Np, Np // 32, 32), fmt,
                                  scale_bits, flush, nonneg=True)
        attn = attn.reshape(B, H, Np, Np)

    out = _dot_in_order(attn, v)
    if bfloat == 16 and not relaxed:
        out = bf16_round_half_away(out)
    out = out[:, :, :N].permute(0, 2, 1, 3).reshape(B, N, H * D)
    return out.to(out_dtype)


# ----------------------------------------------------------------------
# kernel wrapper
# ----------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.topk_attention_qkv_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.topk_attention_qkv_smem_bytes.restype = ctypes.c_longlong
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.topk_attention_qkv.argtypes = [p, p, i, i, i, i, i, i, i, f, i, i,
                                       i, i, i, i, i, i, f, i, p]
    lib.topk_attention_qkv.restype = ctypes.c_int
    return lib


def fused_topk_attention_qkv(qkv: torch.Tensor, num_heads: int, *, k: int,
                             scale: float, block_size: int = 32,
                             mbits: int = 8, scale_bits: int = 8,
                             approx: bool = True, pred_mode: str = "ex_pred",
                             key_bits: int = 32, out_dtype=torch.float32,
                             bfloat: int = 0, flush: bool = False,
                             ebits: int = 0, emax: int = 0,
                             max_norm: float = 0.0,
                             contract: str = "exact") -> torch.Tensor:
    """(B, N, 3*H*D) fused-qkv activations -> (B, N, H*D) attention output.

    K2 on a CUDA tensor; the plain version on a CPU tensor."""
    kw = dict(k=k, scale=scale, block_size=block_size, mbits=mbits,
              scale_bits=scale_bits, approx=approx, pred_mode=pred_mode,
              key_bits=key_bits, out_dtype=out_dtype, bfloat=bfloat,
              flush=flush, ebits=ebits, emax=emax, max_norm=max_norm,
              contract=contract)
    if qkv.device.type == "cpu":
        return fused_topk_attention_qkv_ref(qkv, num_heads, **kw)
    _check_args(pred_mode, approx, contract, key_bits, block_size)
    if qkv.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*D), got {tuple(qkv.shape)}"
                         f" with H={num_heads}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 takes float32 or bfloat16 qkv, not {qkv.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 writes float32 or bfloat16, not {out_dtype}")
    if not qkv.is_contiguous():
        raise ValueError("K2 takes a contiguous qkv tensor")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    B, N, F = qkv.shape
    H = num_heads
    D = F // (3 * H)
    lib = _library()
    if lib.topk_attention_qkv_smem_bytes(N, D) == 0:
        raise NotImplementedError(
            f"K2 holds a head in shared memory and takes N <= {MAX_TOKENS}, "
            f"D <= 128 (got N={N}, D={D}); longer sequences need kernel K4")
    out = torch.empty(B, N, H * D, dtype=out_dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.topk_attention_qkv(
            qkv.data_ptr(), out.data_ptr(), B, N, H, D,
            int(qkv.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            int(k), float(scale), int(approx), int(key_bits),
            int(contract == "serving"), int(bfloat == 16), int(flush),
            int(ebits), int(mbits), int(emax), float(max_norm),
            int(scale_bits), stream)
    if err:
        raise RuntimeError(f"K2 launch failed with CUDA error {err}")
    fused_topk_attention_qkv.launches += 1
    fused_topk_attention_qkv.sites[
        (tuple(qkv.shape), qkv.dtype, num_heads, tuple(kw.items()))] += 1
    return out


# launches, and launches per call site: (qkv shape, qkv dtype, heads,
# keyword arguments)
fused_topk_attention_qkv.launches = 0
fused_topk_attention_qkv.sites = collections.Counter()
