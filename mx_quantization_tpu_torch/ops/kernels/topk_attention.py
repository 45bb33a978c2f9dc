"""Kernels K2, K7, K3 and K4: fused MX top-k attention.

K2 (``csrc/topk_attention_qkv.cu``) takes self-attention straight from the
fused qkv output; it replaces the TPU kernel
``mx_quantization_tpu/ops/kernels/topk_attention.py``
``fused_topk_attention_qkv``.  K7 (the same source, another staging) takes
q and k pre-transposed (2*H*Dp, B, N) and v (B, N, H*D) from the
split-emission qkv projection; it replaces ``fused_topk_attention_qkv_t``
and equals K2 bit for bit on the same q, k, v values; the two take the TPU
entries' whole domain, N <= MAX_TOKENS and every predictor but ELSA.  K3
(``csrc/topk_attention_split.cu``) takes split q (B, H, N, D) and k, v
(B, H, S, D), S != N allowed, with an optional key bias (B, 1, 1, S); it
replaces the short path of ``fused_topk_attention`` (``_split_impl``, N and
S <= 512).  K4 (the same source, a second kernel) computes the same
function for longer sequences (S <= 4096) and replaces ``_split_impl``'s
query-tiled path; ``fused_topk_attention`` takes K3 or K4 by shape, as
``_split_impl`` does, and ``fused_topk_attention_tiled`` is K4 at any
shape, so that K4 can be held to K3 where both apply.  Both quantize each
(row, head) cell's K side once, in a pre-pass of the same call, into a
workspace their wrapper allocates.  Each source's note says what bounds it
and how the design answers.
At every MX block size but 32 the four entries launch one simpler kernel
(``csrc/topk_attention_blocks.cu``, the same function and summation orders,
a warp per query row) instead of their block-32 kernel.
``fused_topk_attention_qkv``, ``fused_topk_attention_qkv_t``,
``fused_topk_attention`` and ``fused_topk_attention_tiled`` launch their
kernel on a CUDA tensor and raise where they cannot; only a CPU tensor
takes the plain versions ``fused_topk_attention_qkv_ref``,
``fused_topk_attention_qkv_t_ref`` and ``fused_topk_attention_ref`` (K3's
and K4's).  Each kernel's shape limits are the constants
below, which the wrappers, the eligibility checks of ``attention.py`` and
(through ``nvcc -D``) the CUDA sources all read.

Numerics (the kernels and their plain versions), per (batch row, head),
in MX blocks of bs elements, bs in BLOCK_SIZES (the block sizes the TPU
kernels take: they pad tokens to a multiple of 128, so bs divides 128; the
tuned kernels take bs = 32, a simpler kernel every other bs, each summing
in the orders below with bs in place of 32):
  * q and k MX-quantized along D (zero-padded to Dp = round_up(max(D, 8),
    bs)), v along the keys in bs-key blocks per column; an f32 input at
    bfloat=16 is first rounded to bf16 half away from zero; flush zeroes a
    block whose maximum is f32-subnormal
  * true scores: each bs-d block summed exactly (INT formats: the integer
    grid points' block sum, multiplied by 2^(eq - (mbits-2)) and then by
    2^(ek - (mbits-2)); MXFP: the products in d order) and the blocks added
    in order; the exact tier rounds them half away to bf16 (bfloat=16),
    then scales; K3 and K4 add the bias
  * ex_pred scores: sign * 2^(block exponent) operands (zeros count as +,
    padded d masked), summed per block and the blocks in order
  * two_step_leading_ones scores: the operand sign * e * (2^l1 +
    2^l2) / 64 per element (e the block exponent, l1 and l2 the leading
    powers of two of the integer mantissa), cast to bf16; on the int grids
    that is n / 64 for an integer |n| <= 12288, so the dot product over
    every d is taken exactly and rounded to f32 once (the kernels: byte
    planes of n in int8 mma, combined in int64); MXFP: the products in d
    order per block, the blocks in order
  * the other predictors, per element of the quantized q and k (JAX
    ``_prep_side``): MXINT4 re-quantizes the side (after its bf16
    round) to the int4 grid; partial_Q keeps q's values and takes ex_pred's
    operand for k, partial_K the reverse; threshold_ex sign * 2^max(te,
    e - 1) with te the value's own exponent (0 at a zero value); true_ex
    sign * 2^te with a zero value mapped to +1 (the padded d masked).  On
    the int grids MXINT4, partial and threshold_ex are small integers times
    a power of two per block, so each block's sum is exact and the blocks
    add in order; true_ex (every format) and every predictor of the MXFP
    grids sum their products in d order per block, the blocks in order,
    on the CUDA cores (true_ex takes that kernel's true score and PV too)
  * ELSA (K3 and K4 only, as in JAX): the hash of a quantized row is the
    sign (>= 0) of each row of ``proj`` (bits, D) times it, the products
    rounded in f32 and added in d order; hamming = the differing bits; the
    score is sqrt(sum kv^2) of the key AT THE QUERY'S INDEX (0 past the
    keys; the reference's square-only quirk) times cos(max(pi / bits *
    hamming - 0.127, 0)), the cosines a table of bits + 1 float32 values
    (``_elsa_cos_table``)
  * K3 and K4 add the bias to the predictor scores too, before the padded keys
    are masked
  * monotone keys truncated to key_bits; the k-th key and the count of
    greater keys (the plain versions by bisection; K2 and K7 by bisection
    over keys packed in registers at key_bits 8 up to 256 keys, else, as
    K3 and K4, by a radix select of 8-bit digits: the same key); exact
    tier: greater keys plus ties lowest index first up to k; serving tier:
    every key >= the k-th; dense (k >= number of keys): every valid key
  * masked softmax (K3 and K4: the softmax sum takes 32 strided sums of
    keys m + 32 i in i order, then halves them in a tree, ``lane_sum``;
    K2 and K7: sixteen strided sums of keys m + 16 i, then a halving tree,
    ``_fragment_sum``)
  * exact tier: attn rounded half away to bf16 (bfloat=16) and MX-quantized
    along the keys with the sign-free quantizer; serving: RNE cast to bf16
  * PV: the serving tier in key order; the exact tier per bs-key block
    exactly (INT: the grid points' block sum times 2^(ep - (mbits-2)),
    then 2^(ev - (mbits-2)); MXFP: key order within the block), the blocks
    in order, then rounded half away to bf16 (bfloat=16); the cast to
    ``out_dtype`` is RNE
The quantized values are kept as bf16 (exact on the int grids), as the TPU
kernels store them, and the plain versions cast them the same way.  Keys and
tokens are zero-padded to a multiple of max(32, bs) and masked; the TPU
kernels pad to 128, which leaves every value unchanged (a padded key's
probability is 0, and every sum above adds it as +0).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from ...formats import FormatParams
from ...predictors.elsa import THETA_BIAS
from ..fastquant import (bf16_round_half_away, lane_sum, pow2, quantize_blocks,
                         round_half_away)
from . import BLOCK_DEFINES, BLOCK_SIZES, build, inference_only

SOURCE = "topk_attention_qkv.cu"
SPLIT_SOURCE = "topk_attention_split.cu"
# K2, K7, K3 and K4 at the block sizes other than 32 (one build, bs a
# launch argument)
BLOCKS_SOURCE = "topk_attention_blocks.cu"
# K2 and K7 hold a whole head in shared memory: at most MAX_TOKENS tokens,
# the TPU kernels' qkv entries' limit
MAX_TOKENS = 512
# K3 stages the keys in chunks: at most MAX_SPLIT_TOKENS queries and keys
# (the TPU kernel's short path); longer sequences are kernel K4's
MAX_SPLIT_TOKENS = 512
# K4 keeps a slot per (query, key) in shared memory: at most MAX_TILED_KEYS
# keys (the TPU kernel's limit; beyond it JAX takes its XLA path)
MAX_TILED_KEYS = 4096
MAX_HEAD_DIM = 128
K2_DEFINES = (("K2_MAX_TOKENS", MAX_TOKENS), ("MAX_HEAD_DIM", MAX_HEAD_DIM))
K3_DEFINES = (("K3_MAX_TOKENS", MAX_SPLIT_TOKENS),
              ("MAX_HEAD_DIM", MAX_HEAD_DIM))
K4_DEFINES = (("K4_MAX_KEYS", MAX_TILED_KEYS),)
SPLIT_DEFINES = K3_DEFINES + K4_DEFINES  # K3 and K4 share their source
# each source builds in parts, each a library with its share of the
# kernels, so that the parts compile side by side (``qkv_builds``,
# ``split_builds``); the source's topk_attention_qkv_part and
# topk_attention_split_part name the part that takes a call
QKV_PARTS = 6
SPLIT_PARTS = 5
# every predictor of the TPU kernels; the index is the C interface's number
SPLIT_PRED_MODES = ("ex_pred", "two_step_leading_ones", "MXINT4", "partial_Q",
                    "partial_K", "true_ex", "threshold_ex", "ELSA")
# the TPU kernels' qkv entries take every predictor but ELSA
QKV_PRED_MODES = SPLIT_PRED_MODES[:-1]
# ELSA's hash holds at most this many bits (a row of the projection each;
# the kernels keep four 32-bit words a row)
MAX_ELSA_BITS = 128
_NEG = -3.0e38


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_args(pred_mode, approx, contract, key_bits, block_size,
                modes=QKV_PRED_MODES):
    if approx and pred_mode not in SPLIT_PRED_MODES:
        raise ValueError(f"unknown pred_mode {pred_mode!r}")
    if approx and pred_mode not in modes:
        raise NotImplementedError(
            f"pred_mode={pred_mode!r}: this kernel serves {modes}, as the "
            "TPU kernel's qkv entry does; the split entry (kernel K3) serves "
            "it")
    if contract not in ("exact", "serving"):
        raise ValueError(f"unknown contract {contract!r}")
    if key_bits not in (8, 16, 32):
        raise ValueError(f"key_bits must be 8, 16 or 32, not {key_bits}")
    if block_size in BLOCK_SIZES:
        return
    if block_size in (1, 2, 4):
        raise NotImplementedError(
            f"block_size={block_size}: the TPU kernels run it, the port's "
            f"attention kernels take {BLOCK_SIZES} (ROADMAP.md)")
    raise ValueError(
        f"block_size={block_size}: the TPU kernels pad tokens to a multiple "
        "of 128 and quantize them in blocks, so the block size must divide "
        f"128; the port's attention kernels take {BLOCK_SIZES}")


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


def _dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, P) in f32, the products added in K order
    as the kernel's multiply-add loop does (the operands are bf16-exact, so
    every product is exact and only the order rounds)."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1], device=a.device)
    for i in range(a.shape[-1]):
        out = out + a[..., :, i, None] * b[..., None, i, :]
    return out


def _pow2_sub(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 for integer e, exact down to the subnormal 2^-149
    (the kernels' ``pow2_sub``)."""
    return torch.pow(2.0, e.to(torch.float64)).to(torch.float32)


def _mx_mantissas(xb: torch.Tensor, fmt, scale_bits: int, flush: bool,
                  nonneg: bool = False):
    """The integer grid points q (float32) and shared exponents e (int32,
    (..., nblocks)) of ``quantize_blocks``' int path on float32 blocks
    (..., nblocks, bs): its value is q * 2^(e - (mbits-2)); q is 0 where
    the scale 2^e or its inverse is 0 (the kernels' ``quant_int``)."""
    _, mbits, emax, _, _ = fmt
    mb = (xb.contiguous().view(torch.int32) & 0x7FFFFFFF).amax(
        dim=-1, keepdim=True)
    if flush:
        xb = torch.where(mb >= 0x00800000, xb, torch.zeros_like(xb))
    scale_emax = 2 ** (scale_bits - 1) - 1
    e = ((mb >> 23) - 127 - emax).clamp(-scale_emax, scale_emax)
    inv_scale, scale = pow2(-e), pow2(e)
    half, qmax = float(2 ** (mbits - 2)), float(2 ** (mbits - 1) - 1)
    s = xb * inv_scale * half
    if nonneg:
        q = torch.clamp(torch.floor(s + 0.5), max=qmax)
    else:
        q = round_half_away(s).clamp(-qmax, qmax)
    q = torch.where((scale == 0) | (inv_scale == 0), 0.0, q)
    return q, e[..., 0]


def _block_scaled_dot(am: torch.Tensor, ae: torch.Tensor, bm: torch.Tensor,
                      be: torch.Tensor, shift: int) -> torch.Tensor:
    """Blockwise product of integer grid points: am (..., M, nb, bs) with
    exponents ae (..., M, nb), bm (..., P, nb, bs) with be (..., P, nb) ->
    (..., M, P).  Each block's sum is exact (an integer below 2^24, as the
    kernels' int8 mma gives it); in f32 it is multiplied by 2^(ae - shift),
    then by 2^(be - shift), and the blocks are added in order."""
    blk = torch.einsum("...mkd,...pkd->...mpk", am.to(torch.float64),
                       bm.to(torch.float64)).to(torch.float32)
    pa, pb = _pow2_sub(ae - shift), _pow2_sub(be - shift)
    out = None
    for i in range(blk.shape[-1]):
        term = blk[..., i] * pa[..., :, None, i] * pb[..., None, :, i]
        out = term if out is None else out + term
    return out


def _blocks_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, nb, bs) and b (..., P, nb, bs) -> (..., M, P): each
    block's f32 sum in index order (``_dot_in_order``), then the blocks
    added in order."""
    out = None
    for i in range(a.shape[-2]):
        term = _dot_in_order(a[..., i, :], b[..., i, :].transpose(-1, -2))
        out = term if out is None else out + term
    return out


def _fragment_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a multiple of 16) in K2's order on the mma
    accumulator layout: sixteen sums of keys m + 16 i, each in i order, then
    halved in a tree (m + 8, m + 4, m + 2, m + 1).  Lane t of a quad holds
    m = 8 p + 2 t + e: p and e within the lane, t across the quad.  Returns
    (..., 1)."""
    x = e.reshape(*e.shape[:-1], -1, 16)
    acc = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        acc = acc + x[..., i, :]
    for h in (8, 4, 2, 1):
        acc = acc[..., :h] + acc[..., h:2 * h]
    return acc


def _d_mask(vals: torch.Tensor, d_valid: int) -> torch.Tensor:
    """1 at the valid d of blocks (..., nb, bs), 0 at the padding."""
    nb, bs = vals.shape[-2:]
    return (torch.arange(nb * bs, device=vals.device) < d_valid).reshape(
        nb, bs).to(vals.dtype)


def _ex_pred_operand(vals: torch.Tensor, e: torch.Tensor,
                     d_valid: int) -> torch.Tensor:
    """ex_pred operands +-2^e (zeros count as +) of quantized blocks
    (..., nb, bs) with exponents (..., nb, 1); padded d masked."""
    pw = pow2(e.clamp(-126, 127))
    return torch.where(vals < 0, -pw, pw) * _d_mask(vals, d_valid)


def _blockwise_scores(aq: torch.Tensor, ak: torch.Tensor) -> torch.Tensor:
    """ex_pred scores from operands (..., N, nb, bs) and (..., S, nb, bs):
    every per-block sum is exact, the blocks add in order."""
    blk = torch.einsum("...nkd,...skd->...nsk", aq, ak)
    out = blk[..., 0]
    for i in range(1, blk.shape[-1]):
        out = out + blk[..., i]
    return out


def _two_step_operand(vals: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """two_step_leading_ones operands of quantized blocks (..., nb, bs)
    (bf16-exact) with exponents (..., nb, 1): sign(m) * e * (2^l1 + 2^l2)
    / 64, m = vals * 2^-e * 64, in the f32 operations and order of the TPU
    kernel's ``_two_step_approx``, then the bf16 cast.  e is the block
    exponent itself, not 2^e: a block with e = 0 contributes nothing."""
    ec = e.clamp(-127, 127)
    inv = ((127 - ec) << 23).to(torch.int32).view(torch.float32)  # 0 at 127
    m = vals * inv * 64.0

    def lead_pow(x):  # 2^floor(log2 x) for x >= 0; zero -> 2^-126
        lg = torch.where(x == 0, -126, (x.contiguous().view(torch.int32) >> 23)
                         - 127)
        return ((lg + 127) << 23).to(torch.int32).view(torch.float32)

    p1 = lead_pow(m.abs())
    resid = m - p1  # signed: a negative m leaves p2 = 2^-126
    p2 = lead_pow(torch.where(resid < 0, 0.0, resid))
    mag = (p1 + p2) / 64.0
    sgn = torch.where(m < 0, -1.0, torch.where(m == 0, 0.0, 1.0))
    return (sgn * e.to(torch.float32) * mag).to(torch.bfloat16).to(
        torch.float32)


def _attention_probs(st: torch.Tensor, s_sel, n_keys: int, *, k: int,
                     key_bits: int, relaxed: bool, bfloat: int,
                     row_sum=lane_sum) -> torch.Tensor:
    """Scaled true scores st (..., Kp) and predictor scores s_sel (None:
    select by st) -> the attention probabilities, (..., Kp): the serving
    tier's bf16 values, the exact tier's before its MX quantize.
    ``row_sum`` is the softmax sum's order."""
    Kp = st.shape[-1]
    valid = torch.arange(Kp, device=st.device) < n_keys
    if k >= n_keys:
        sel = valid.expand(st.shape)
    else:
        s_sel = torch.where(valid, st if s_sel is None else s_sel, _NEG)
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
    attn = ex / row_sum(ex)
    if relaxed:
        return attn.to(torch.bfloat16).to(torch.float32)
    return bf16_round_half_away(attn) if bfloat == 16 else attn


def fused_topk_attention_qkv_ref(qkv: torch.Tensor, num_heads: int, *,
                                 k: int, scale: float,
                                 n_valid: Optional[int] = None, **kw
                                 ) -> torch.Tensor:
    """Plain PyTorch version of K2: q, k and v cut from the fused layout and
    handed to the plain attention K3 and K4 share (``_attention_ref``),
    with K2's softmax sum (``_fragment_sum``).  Keys at or past ``n_valid``
    (default: all N tokens) are masked; every token gets its query row.
    Keywords as ``fused_topk_attention_ref``'s (no bias, no ELSA)."""
    _check_args(kw.get("pred_mode", "ex_pred"), kw.get("approx", True),
                kw.get("contract", "exact"), kw.get("key_bits", 32),
                kw.get("block_size", 32))
    B, N, F = qkv.shape
    n_valid = N if n_valid is None else n_valid
    H = num_heads
    D = F // (3 * H)
    q, k_, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
    out = _attention_ref(q, k_[:, :, :n_valid], v[:, :, :n_valid], None,
                         None, _fragment_sum, k=k, scale=scale, **kw)
    return out.permute(0, 2, 1, 3).reshape(B, N, H * D)


def _split_t_shapes(qk_t: torch.Tensor, v: torch.Tensor, num_heads: int):
    """(H, Dp, D) of K7's operands, checked."""
    H = num_heads
    if qk_t.dim() != 3 or v.dim() != 3 or qk_t.shape[0] % (2 * H) or \
            v.shape[2] % H or tuple(v.shape[:2]) != tuple(qk_t.shape[1:]):
        raise ValueError("qk_t must be (2*H*Dp, B, N) and v (B, N, H*D), got "
                         f"{tuple(qk_t.shape)}, {tuple(v.shape)} with H={H}")
    Dp, D = qk_t.shape[0] // (2 * H), v.shape[2] // H
    if Dp < D:
        raise ValueError(f"qk_t has {Dp} rows per head, fewer than D={D}")
    return H, Dp, D


def fused_topk_attention_qkv_t_ref(qk_t: torch.Tensor, v: torch.Tensor,
                                   num_heads: int, *, k: int, scale: float,
                                   n_valid: int, **kw) -> torch.Tensor:
    """Plain PyTorch version of K7: the operands rearranged to the fused
    qkv layout (each head's first D rows of q and k; the padded rows are
    zero) and handed to K2's plain version.  Keywords as K2's."""
    H, Dp, D = _split_t_shapes(qk_t, v, num_heads)
    _, B, N = qk_t.shape
    qk = qk_t.reshape(2, H, Dp, B, N)[:, :, :D].permute(3, 4, 0, 1, 2)
    qkv = torch.cat([qk.reshape(B, N, 2 * H * D), v.to(qk_t.dtype)], dim=-1)
    return fused_topk_attention_qkv_ref(qkv, H, k=k, scale=scale,
                                        n_valid=n_valid, **kw)


def _split_blocks(x: torch.Tensor, n_pad: int, Dp: int, bfloat: int,
                  block_size: int = 32) -> torch.Tensor:
    """(B, H, n, D) -> float32 blocks along D (B, H, n_pad, Dp / bs, bs),
    zero padded, rounded half away to bf16 first where bfloat=16."""
    x32 = x.to(torch.float32)
    if bfloat == 16 and x.dtype != torch.bfloat16:
        x32 = bf16_round_half_away(x32)
    x32 = torch.nn.functional.pad(x32, (0, Dp - x.shape[-1],
                                        0, n_pad - x.shape[-2]))
    return x32.reshape(*x32.shape[:-1], Dp // block_size, block_size)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _exact_int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, nb, bs) @ b (..., P, nb, bs)^T over every d, in float64
    (exact: the operands are n / 64 with |n| < 2^14 integers, so every
    product and partial sum is a multiple of 2^-12 below 2^23), cast to
    float32 once (the kernels' int8 byte-plane products in int64)."""
    flat = a.shape[:-2] + (-1,)
    return torch.matmul(a.reshape(flat).double(), b.reshape(
        b.shape[:-2] + (-1,)).double().transpose(-1, -2)).to(torch.float32)


def _blockwise_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, nb, bs) @ b (..., P, nb, bs)^T: each block's sum exact (in
    float64; the operands are small integers times a power of two per block,
    as the kernels' int8 mma sums them), rounded to f32, the blocks added
    in order."""
    blk = torch.einsum("...mkd,...pkd->...mpk", a.double(), b.double()).to(
        torch.float32)
    out = blk[..., 0]
    for i in range(1, blk.shape[-1]):
        out = out + blk[..., i]
    return out


def _own_exponent(vals: torch.Tensor) -> torch.Tensor:
    """floor(log2 |v|) from the bits of v (0 at v == 0), int32."""
    te = (vals.abs().contiguous().view(torch.int32) >> 23) - 127
    return torch.where(vals == 0, 0, te)


def _threshold_ex_operand(vals: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """threshold_ex: sign(v) * 2^max(te, e - 1), sign(0) = 0 (JAX
    ``_threshold_ex_approx``)."""
    th = torch.maximum(_own_exponent(vals), e - 1)
    return torch.sign(vals) * pow2(th.clamp(-126, 127))


def _true_ex_operand(vals: torch.Tensor, d_valid: int) -> torch.Tensor:
    """true_ex: sign(v) * 2^te, a zero value mapped to +1 (JAX
    ``_true_ex_approx``), the padded d masked."""
    pw = pow2(_own_exponent(vals).clamp(-126, 127))
    return torch.where(vals < 0, -pw, pw) * _d_mask(vals, d_valid)


def _pred_operands(pred_mode, sides, d_valid, scale_bits, flush):
    """The predictor operands (q's, k's) of ``pred_mode`` (not ex_pred or
    ELSA) from each side's (blocks after the bf16 round, quantized values,
    block exponents)."""
    def one(side, xb, vals, e):
        if pred_mode == "two_step_leading_ones":
            return _two_step_operand(vals, e)
        if pred_mode == "MXINT4":  # the original side on the int4 grid
            v4, _ = quantize_blocks(xb, FormatParams(0, 4, 0, 0.0, 0.0),
                                    scale_bits, flush)
            return v4
        if pred_mode == "threshold_ex":
            return _threshold_ex_operand(vals, e)
        if pred_mode == "true_ex":
            return _true_ex_operand(vals, d_valid)
        if pred_mode == f"partial_{side}":  # the full-mantissa side
            return vals
        return _ex_pred_operand(vals, e, d_valid)  # partial's other side
    return tuple(one(side, *x) for side, x in zip("QK", sides))


@functools.lru_cache(maxsize=None)
def _elsa_cos_table(bits: int, device=torch.device("cpu")) -> torch.Tensor:
    """cos(max(pi / bits * h - 0.127, 0)) for every hamming distance h =
    0 .. bits, each operation in float32 (JAX's ``_score_select_output``);
    the plain versions and the kernels read this one table."""
    h = torch.arange(bits + 1, dtype=torch.float32)
    ang = h * torch.tensor(math.pi / bits, dtype=torch.float32) - torch.tensor(
        THETA_BIAS, dtype=torch.float32)
    return torch.cos(torch.clamp(ang, min=0.0)).to(device)


def _elsa_hash(vals: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """+-1 signs (float32) of proj (bits, D) times each row of vals (...,
    n, nb, bs): the products rounded in f32 and added in d order, >= 0 ->
    +1.  Returns (..., n, bits)."""
    v = vals.reshape(*vals.shape[:-2], -1)
    acc = torch.zeros(*v.shape[:-1], proj.shape[0], device=vals.device)
    for d in range(proj.shape[1]):
        acc = acc + v[..., d, None] * proj[:, d]
    return torch.where(acc >= 0, 1.0, -1.0)


def _elsa_scores(qv: torch.Tensor, kv: torch.Tensor,
                 proj: torch.Tensor) -> torch.Tensor:
    """ELSA's predictor scores (B, H, N, Sp) from the quantized q (B, H, N,
    nb, bs) and k (B, H, Sp, nb, bs): the norm of key n at query row n
    (sum of squares in d order; 0 past the keys) times the cosine of the
    angle its hamming distance estimates."""
    bits, D = proj.shape
    hq, hk = _elsa_hash(qv, proj), _elsa_hash(kv, proj)
    # the +-1 dot over at most 128 bits is an exact integer in f32
    ham = ((bits - torch.matmul(hq, hk.transpose(-1, -2))) * 0.5).long()
    k2 = kv.reshape(*kv.shape[:-2], -1)
    nsum = torch.zeros(k2.shape[:-1], device=kv.device)
    for d in range(D):
        nsum = nsum + k2[..., d] * k2[..., d]
    N, Sp = qv.shape[-3], kv.shape[-3]
    norm = torch.nn.functional.pad(torch.sqrt(nsum),
                                   (0, max(0, N - Sp)))[..., :N]
    return norm[..., None] * _elsa_cos_table(bits, qv.device)[ham]


def _check_proj(proj, D: int):
    if proj is None:
        raise ValueError("pred_mode='ELSA' needs the projection matrix")
    if proj.dim() != 2 or proj.shape[1] != D or \
            not 1 <= proj.shape[0] <= MAX_ELSA_BITS:
        raise NotImplementedError(
            f"ELSA takes a (bits, D={D}) projection with 1 <= bits <= "
            f"{MAX_ELSA_BITS}, got {tuple(proj.shape)}")


def _int_route(ebits: int, pred: Optional[str]) -> bool:
    """Do K3 and K4 take their int-grid kernel (tensor-core products)?
    true_ex and the MXFP grids take the CUDA-core one."""
    return ebits == 0 and pred != "true_ex"


def _split_score_sums(q: torch.Tensor, k_: torch.Tensor, fmt,
                      scale_bits: int, flush: bool, bfloat: int,
                      pred_mode: Optional[str], proj=None,
                      block_size: int = 32):
    """K3's and K4's true scores and (``pred_mode`` not None) predictor
    scores of q (B, H, N, D) against k (B, H, S, D), before the exact
    tier's round, the scale and the bias: (B, H, N, S padded to a multiple
    of max(32, bs)) float32 each, the predictor's None without a predictor.
    The true score sums each bs-d block exactly and the blocks in order (the int-grid kernel:
    ``_block_scaled_dot``; the CUDA-core one: ``_blocks_in_order``);
    two_step's int-grid predictor is one exact dot rounded once
    (``_exact_int_dot``); ex_pred's, MXINT4's, partial's and threshold_ex's
    int-grid predictors sum each block exactly, the blocks in order; the
    CUDA-core kernel's predictors ``_blocks_in_order``; ELSA
    ``_elsa_scores``."""
    N, D = q.shape[-2:]
    bs = block_size
    Sp = _round_up(k_.shape[-2], max(32, bs))
    Dp = _round_up(max(D, 8), bs)
    int_route = _int_route(fmt[0], pred_mode)
    qb = _split_blocks(q, N, Dp, bfloat, bs)
    kb = _split_blocks(k_, Sp, Dp, bfloat, bs)
    # the kernels stage the quantized values as bf16 (exact on the int
    # grids; an MXFP value below bf16's 2^-133 rounds)
    qv, qe = quantize_blocks(qb, fmt, scale_bits, flush)
    kv, ke = quantize_blocks(kb, fmt, scale_bits, flush)
    qv, kv = _bf16(qv), _bf16(kv)
    if int_route:  # the kernels' int8 grid points and exponents
        qm, qme = _mx_mantissas(qb, fmt, scale_bits, flush)
        km, kme = _mx_mantissas(kb, fmt, scale_bits, flush)
        st = _block_scaled_dot(qm, qme, km, kme, fmt[1] - 2)
    else:
        st = _blocks_in_order(qv, kv)
    if pred_mode is None:
        return st, None
    if pred_mode == "ELSA":
        return st, _elsa_scores(qv, kv, proj.to(q.device, torch.float32))
    if pred_mode == "ex_pred":
        return st, _blockwise_scores(_ex_pred_operand(qv, qe, D),
                                     _ex_pred_operand(kv, ke, D))
    aq, ak = _pred_operands(pred_mode, ((qb, qv, qe), (kb, kv, ke)), D,
                            scale_bits, flush)
    if not int_route:
        return st, _blocks_in_order(aq, ak)
    if pred_mode == "two_step_leading_ones":
        return st, _exact_int_dot(aq, ak)
    return st, _blockwise_exact(aq, ak)


def fused_topk_attention_ref(q: torch.Tensor, k_: torch.Tensor,
                             v: torch.Tensor, bias=None, proj=None,
                             **kw) -> torch.Tensor:
    """Plain PyTorch version of K3 and K4, vectorized over (batch, head,
    query): q (B, H, N, D), k and v (B, H, S, D), bias (B, 1, 1, S) or
    None, proj (bits, D) for ELSA -> (B, H, N, D).  Keywords as the
    wrappers'."""
    _check_args(kw.get("pred_mode", "ex_pred"), kw.get("approx", True),
                kw.get("contract", "exact"), kw.get("key_bits", 32),
                kw.get("block_size", 32), SPLIT_PRED_MODES)
    return _attention_ref(q, k_, v, bias, proj, lane_sum, **kw)


def _attention_ref(q: torch.Tensor, k_: torch.Tensor, v: torch.Tensor,
                   bias, proj, row_sum, *, k: int, scale: float,
                   block_size: int = 32, mbits: int = 8, scale_bits: int = 8,
                   approx: bool = True, pred_mode: str = "ex_pred",
                   key_bits: int = 32, out_dtype=torch.float32,
                   bfloat: int = 0, flush: bool = False, ebits: int = 0,
                   emax: int = 0, max_norm: float = 0.0,
                   contract: str = "exact") -> torch.Tensor:
    """The plain attention of K2, K3, K4 and K7 (the caller checks the
    arguments): ``row_sum`` is the softmax sum's order, K3's and K4's
    ``lane_sum`` or K2's and K7's ``_fragment_sum``."""
    relaxed = contract == "serving"
    fmt = FormatParams(ebits, mbits, emax, max_norm, 0.0)
    B, H, N, D = q.shape
    S = k_.shape[2]
    bs = block_size
    Sp = _round_up(S, max(32, bs))
    shift = mbits - 2
    pred = pred_mode if approx and k < S else None
    if pred == "ELSA":
        _check_proj(proj, D)
    int_fmt = _int_route(ebits, pred)
    st, s_sel = _split_score_sums(q, k_, fmt, scale_bits, flush, bfloat, pred,
                                  proj, bs)
    v32 = v.to(torch.float32)
    if bfloat == 16 and v.dtype != torch.bfloat16:
        v32 = bf16_round_half_away(v32)
    vt = torch.nn.functional.pad(v32, (0, 0, 0, Sp - S)).transpose(
        -1, -2).reshape(B, H, D, Sp // bs, bs)
    if int_fmt:  # the kernels' int8 grid points and exponents
        vm, ve = _mx_mantissas(vt, fmt, scale_bits, flush)
        vq = (vm * _pow2_sub(ve - shift)[..., None]).reshape(
            B, H, D, Sp).transpose(-1, -2)  # (B, H, Sp, D)
    else:
        vq, _ = quantize_blocks(vt, fmt, scale_bits, flush)
        vq = _bf16(vq).reshape(B, H, D, Sp).transpose(-1, -2)
    if bfloat == 16 and not relaxed:
        st = bf16_round_half_away(st)
    st = st * scale
    if bias is not None:
        if tuple(bias.shape) != (B, 1, 1, S):
            raise ValueError(f"bias must be (B, 1, 1, S) = {(B, 1, 1, S)}, "
                             f"got {tuple(bias.shape)}")
        brow = torch.nn.functional.pad(bias.to(torch.float32), (0, Sp - S))
        st = st + brow
        if s_sel is not None:
            s_sel = s_sel + brow
    attn = _attention_probs(st, s_sel, S, k=k, key_bits=key_bits,
                            relaxed=relaxed, bfloat=bfloat, row_sum=row_sum)

    if relaxed:  # bf16 probabilities: key order
        out = _dot_in_order(attn, vq)
    else:
        ab = attn.reshape(B, H, N, Sp // bs, bs)
        if int_fmt:
            pm, pe = _mx_mantissas(ab, fmt, scale_bits, flush, nonneg=True)
            out = _block_scaled_dot(pm, pe, vm, ve, shift)
        else:
            pv, _ = quantize_blocks(ab, fmt, scale_bits, flush, nonneg=True)
            out = _blocks_in_order(_bf16(pv), vq.transpose(-1, -2).reshape(
                B, H, D, Sp // bs, bs))
        out = bf16_round_half_away(out) if bfloat == 16 else out
    return out.to(out_dtype)


# ----------------------------------------------------------------------
# kernel wrapper
# ----------------------------------------------------------------------
def qkv_builds():
    """(source, definitions) of each part of K2's and K7's build."""
    return [(SOURCE, K2_DEFINES + (("QKV_PART", i),))
            for i in range(QKV_PARTS)]


@functools.cache
def _qkv_library(part: int) -> ctypes.CDLL:
    return bind_qkv_library(build.load(*qkv_builds()[part]))


def bind_qkv_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``SOURCE``."""
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.topk_attention_qkv_smem_bytes.argtypes = [i] * 9
    lib.topk_attention_qkv_smem_bytes.restype = ctypes.c_longlong
    lib.topk_attention_qkv_plan.argtypes = [i] * 9
    lib.topk_attention_qkv_plan.restype = i
    lib.topk_attention_qkv_part.argtypes = [i] * 9
    lib.topk_attention_qkv_part.restype = i
    lib.topk_attention_qkv.argtypes = [p, p] + [i] * 7 + [f] + [i] * 9 + [
        f, i, p]
    lib.topk_attention_qkv.restype = i
    lib.topk_attention_qkv_t.argtypes = [p] * 3 + [i] * 9 + [f] + [
        i] * 9 + [f, i, p]
    lib.topk_attention_qkv_t.restype = i
    return lib


def qkv_call_args(N: int, n_valid: int, D: int, kw) -> tuple:
    """The shape queries' arguments of a K2 or K7 call: Nq, n_valid, D,
    topk, approx, pred_mode (``_pred_index``), key_bits, relaxed, ebits."""
    return (N, n_valid, D, int(kw["k"]), int(kw["approx"]), _pred_index(kw),
            int(kw["key_bits"]), int(kw["contract"] == "serving"),
            int(kw["ebits"]))


def _check_qkv_shape(name: str, N: int, D: int):
    if N > MAX_TOKENS or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{name} holds a head in shared memory and takes N <= "
            f"{MAX_TOKENS}, D <= {MAX_HEAD_DIM} (got N={N}, D={D}); the "
            "split entry (kernel K3 or K4) takes longer sequences")


def _qkv_lib(name: str, N: int, n_valid: int, D: int, kw):
    """The library (the build part) that launches a K2 or K7 call; raises
    where the kernel cannot take it."""
    _check_qkv_shape(name, N, D)
    part = _qkv_library(0).topk_attention_qkv_part(
        *qkv_call_args(N, n_valid, D, kw))
    if part < 0:
        raise NotImplementedError(
            f"{name}: a cell of N={N}, D={D} with {kw['pred_mode']}, "
            f"ebits={kw['ebits']}, key_bits={kw['key_bits']} does not fit a "
            "block's shared memory (ROADMAP.md)")
    return _qkv_library(part)


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
    out = torch.empty(B, N, H * D, dtype=out_dtype, device=qkv.device)
    if block_size != 32:
        _check_qkv_shape("K2", N, D)
        _launch_blocks("K2", 0, (qkv, None, None), None, None, out,
                       (B, H, N, N, D, N, 0), kw)
    else:
        lib = _qkv_lib("K2", N, N, D, kw)
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.topk_attention_qkv(
                qkv.data_ptr(), out.data_ptr(), B, N, H, D,
                int(qkv.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), *_launch_args(kw), stream)
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


# ----------------------------------------------------------------------
# K7 wrapper
# ----------------------------------------------------------------------
def fused_topk_attention_qkv_t(qk_t: torch.Tensor, v: torch.Tensor,
                               num_heads: int, *, k: int, scale: float,
                               n_valid: int, block_size: int = 32,
                               mbits: int = 8, scale_bits: int = 8,
                               approx: bool = True,
                               pred_mode: str = "ex_pred",
                               key_bits: int = 32, out_dtype=torch.float32,
                               bfloat: int = 0, flush: bool = False,
                               ebits: int = 0, emax: int = 0,
                               max_norm: float = 0.0,
                               contract: str = "exact") -> torch.Tensor:
    """qk_t (2*H*Dp, B, N) pre-transposed q and k (each head's Dp rows, the
    rows past D and the tokens past ``n_valid`` zero) and v (B, N, H*D) ->
    (B, N, H*D) attention output; keys past ``n_valid`` are masked.

    K7 on CUDA tensors; the plain version on CPU tensors."""
    kw = dict(k=k, scale=scale, n_valid=n_valid, block_size=block_size,
              mbits=mbits, scale_bits=scale_bits, approx=approx,
              pred_mode=pred_mode, key_bits=key_bits, out_dtype=out_dtype,
              bfloat=bfloat, flush=flush, ebits=ebits, emax=emax,
              max_norm=max_norm, contract=contract)
    inference_only("K7 (fused_topk_attention_qkv_t)", qk_t, v)
    if qk_t.device.type == "cpu":
        return fused_topk_attention_qkv_t_ref(qk_t, v, num_heads, **kw)
    _check_args(pred_mode, approx, contract, key_bits, block_size)
    if qk_t.device.type != "cuda" or v.device != qk_t.device:
        raise ValueError("K7 runs on CUDA tensors of one device (or on CPU "
                         f"tensors), not {qk_t.device}, {v.device}")
    H, Dp, D = _split_t_shapes(qk_t, v, num_heads)
    _, B, N = qk_t.shape
    if qk_t.dtype not in (torch.float32, torch.bfloat16) or \
            v.dtype != qk_t.dtype:
        raise TypeError("K7 takes float32 or bfloat16 qk_t and v of one "
                        f"dtype, not {qk_t.dtype}, {v.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K7 writes float32 or bfloat16, not {out_dtype}")
    if not (qk_t.is_contiguous() and v.is_contiguous()):
        raise ValueError("K7 takes contiguous qk_t and v")
    if k < 1 or not 1 <= n_valid <= N:
        raise ValueError(f"need k >= 1 and 1 <= n_valid <= N={N}, got k={k}, "
                         f"n_valid={n_valid}")
    out = torch.empty(B, N, H * D, dtype=out_dtype, device=qk_t.device)
    if block_size != 32:
        _check_qkv_shape("K7", N, D)
        _launch_blocks("K7", 1, (qk_t, v, None), None, None, out,
                       (B, H, N, int(n_valid), D, N, Dp), kw)
    else:
        lib = _qkv_lib("K7", N, n_valid, D, kw)
        with torch.cuda.device(qk_t.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.topk_attention_qkv_t(
                qk_t.data_ptr(), v.data_ptr(), out.data_ptr(), B, N,
                int(n_valid), H, D, Dp, int(qk_t.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), *_launch_args(kw), stream)
        if err:
            raise RuntimeError(f"K7 launch failed with CUDA error {err}")
    fused_topk_attention_qkv_t.launches += 1
    fused_topk_attention_qkv_t.sites[
        (tuple(qk_t.shape), tuple(v.shape), qk_t.dtype, num_heads,
         tuple(kw.items()))] += 1
    return out


# launches, and launches per call site: (qk_t shape, v shape, dtype, heads,
# keyword arguments)
fused_topk_attention_qkv_t.launches = 0
fused_topk_attention_qkv_t.sites = collections.Counter()


# ----------------------------------------------------------------------
# K3 and K4 wrappers
# ----------------------------------------------------------------------
def split_builds():
    """(source, definitions) of each part of K3's and K4's build."""
    return [(SPLIT_SOURCE, SPLIT_DEFINES + (("SPLIT_PART", i),))
            for i in range(SPLIT_PARTS)]


@functools.cache
def _split_library(part: int) -> ctypes.CDLL:
    return bind_split_library(build.load(*split_builds()[part]))


def bind_split_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``SPLIT_SOURCE``."""
    i, f, p, ll = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, \
        ctypes.c_longlong
    lib.topk_attention_split_smem_bytes.argtypes = [i] * 10
    lib.topk_attention_split_smem_bytes.restype = ll
    lib.topk_attention_split_workspace_bytes.argtypes = [i] * 9
    lib.topk_attention_split_workspace_bytes.restype = ll
    lib.topk_attention_split_part.argtypes = [i] * 5
    lib.topk_attention_split_part.restype = i
    lib.topk_attention_split.argtypes = [p] * 8 + [i] * 8 + [f] + [
        i] * 9 + [f, i, i, i, p]
    lib.topk_attention_split.restype = i
    return lib


def _split_operands(name, q, k_, v, bias, proj, kw):
    """Check a CUDA call of K3 or K4; returns (B, H, N, S, D), the bias as a
    contiguous (B, S) float32 tensor or None, and (ELSA) the projection as a
    contiguous float32 tensor or None."""
    _check_args(kw["pred_mode"], kw["approx"], kw["contract"],
                kw["key_bits"], kw["block_size"], SPLIT_PRED_MODES)
    elsa = kw["approx"] and kw["pred_mode"] == "ELSA" and \
        kw["k"] < k_.shape[-2]
    if elsa:
        _check_proj(proj, q.shape[-1])
    else:
        proj = None
    tensors = [q, k_, v] + [t for t in (bias, proj) if t is not None]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name} runs on CUDA tensors of one device (or on "
                         f"CPU tensors), not {[str(t.device) for t in tensors]}")
    if q.dim() != 4 or k_.dim() != 4 or v.shape != k_.shape or \
            q.shape[:2] != k_.shape[:2] or q.shape[3] != k_.shape[3]:
        raise ValueError("q must be (B, H, N, D) and k, v (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k_.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q, k, v of one "
                        f"dtype, not {q.dtype}, {k_.dtype}, {v.dtype}")
    if kw["out_dtype"] not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} writes float32 or bfloat16, not "
                        f"{kw['out_dtype']}")
    if not (q.is_contiguous() and k_.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous q, k and v")
    if kw["k"] < 1:
        raise ValueError(f"k must be >= 1, got {kw['k']}")
    B, H, N, D = q.shape
    S = k_.shape[2]
    if proj is not None:
        proj = proj.to(torch.float32).contiguous()
    if bias is None:
        return (B, H, N, S, D), None, proj
    if tuple(bias.shape) != (B, 1, 1, S):
        raise ValueError(f"bias must be (B, 1, 1, S) = {(B, 1, 1, S)}, "
                         f"got {tuple(bias.shape)}")
    return ((B, H, N, S, D), bias.reshape(B, S).to(torch.float32).contiguous(),
            proj)


def _pred_index(kw) -> int:
    """The C interface's number of the call's predictor (its index in
    SPLIT_PRED_MODES, which QKV_PRED_MODES shares; 0 without one)."""
    return SPLIT_PRED_MODES.index(kw["pred_mode"]) if kw["approx"] else 0


def _launch_args(kw):
    """The trailing launch arguments K2, K3, K4 and K7 share, from the
    wrapper's keywords: topk, scale, approx, pred_mode (``_pred_index``),
    key_bits, relaxed, bfloat16, flush, ebits, mbits, emax, max_norm,
    scale_bits."""
    return (int(kw["k"]), float(kw["scale"]), int(kw["approx"]),
            _pred_index(kw),
            int(kw["key_bits"]), int(kw["contract"] == "serving"),
            int(kw["bfloat"] == 16), int(kw["flush"]), int(kw["ebits"]),
            int(kw["mbits"]), int(kw["emax"]), float(kw["max_norm"]),
            int(kw["scale_bits"]))


@functools.cache
def _blocks_library() -> ctypes.CDLL:
    lib = build.load(BLOCKS_SOURCE, BLOCK_DEFINES)
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.topk_attention_blocks_workspace_bytes.argtypes = [i] * 12
    lib.topk_attention_blocks_workspace_bytes.restype = ctypes.c_longlong
    lib.topk_attention_blocks.argtypes = [i] + [p] * 8 + [i] * 11 + [f] + [
        i] * 9 + [f, i, i, p]
    lib.topk_attention_blocks.restype = i
    return lib


def _launch_blocks(name, entry, inputs, brow, pmat, out, dims, kw):
    """Launch ``BLOCKS_SOURCE``'s kernel (K2, K7, K3 or K4 at a block size
    other than 32) into ``out``: entry 0 K2, 1 K7, 2 K3/K4; inputs the
    entry's tensors (K2: qkv; K7: qk_t, v; K3/K4: q, k, v); dims (B, H, N
    query rows, S valid keys, D, the input's tokens, K7's rows per head).
    The wrapper has checked the operands; raises where the kernel cannot
    take the call."""
    B, H, N, S, D, n_in, dp_in = dims
    bs = kw["block_size"]
    args = _launch_args(kw)
    topk, approx, pred, ebits = args[0], args[2], args[3], args[8]
    bits = 0 if pmat is None else pmat.shape[0]
    lib = _blocks_library()
    nbytes = lib.topk_attention_blocks_workspace_bytes(
        entry, B, H, N, S, D, bs, topk, approx, pred, ebits, bits)
    if nbytes <= 0:
        raise NotImplementedError(
            f"{name} at block {bs} takes S <= {MAX_TILED_KEYS} and a padded "
            f"head dim <= {MAX_HEAD_DIM} (got N={N}, S={S}, D={D})")
    dev = out.device
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    cos = None if pmat is None else _elsa_cos_table(bits, dev)
    ptr = [None if t is None else t.data_ptr()
           for t in (*inputs, brow, pmat, cos)]
    with torch.cuda.device(dev):
        err = lib.topk_attention_blocks(
            entry, *ptr, ws.data_ptr(), out.data_ptr(), B, H, N, S, D, n_in,
            dp_in, bs, int(inputs[0].dtype == torch.bfloat16),
            int(out.dtype == torch.bfloat16), *args, bits,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} (block {bs}) launch failed with CUDA "
                           f"error {err}")


def _count(wrapper, q, k_, bias, proj, kw):
    wrapper.launches += 1
    wrapper.sites[(tuple(q.shape), tuple(k_.shape), q.dtype,
                   None if bias is None else tuple(bias.shape),
                   None if proj is None else tuple(proj.shape),
                   tuple(kw.items()))] += 1


def fused_topk_attention(q: torch.Tensor, k_: torch.Tensor, v: torch.Tensor,
                         bias=None, proj=None, *, k: int, scale: float,
                         block_size: int = 32, mbits: int = 8,
                         scale_bits: int = 8, approx: bool = True,
                         pred_mode: str = "ex_pred", key_bits: int = 32,
                         out_dtype=torch.float32, bfloat: int = 0,
                         flush: bool = False, ebits: int = 0, emax: int = 0,
                         max_norm: float = 0.0,
                         contract: str = "exact") -> torch.Tensor:
    """q (B, H, N, D), k and v (B, H, S, D), optional key bias (B, 1, 1, S)
    and, for ELSA, the projection proj (bits, D) -> (B, H, N, D) attention
    output.

    On CUDA tensors K3 where N, S <= MAX_SPLIT_TOKENS, else K4 (through
    ``fused_topk_attention_tiled``), as the TPU kernel takes its short or
    its query-tiled path; the plain version on CPU tensors."""
    kw = dict(k=k, scale=scale, block_size=block_size, mbits=mbits,
              scale_bits=scale_bits, approx=approx, pred_mode=pred_mode,
              key_bits=key_bits, out_dtype=out_dtype, bfloat=bfloat,
              flush=flush, ebits=ebits, emax=emax, max_norm=max_norm,
              contract=contract)
    if q.device.type == "cpu":
        return fused_topk_attention_ref(q, k_, v, bias, proj, **kw)
    if max(q.shape[-2], k_.shape[-2]) > MAX_SPLIT_TOKENS:
        return fused_topk_attention_tiled(q, k_, v, bias, proj, **kw)
    return _launch_split("K3", fused_topk_attention, q, k_, v, bias, proj,
                         kw)


def check_split_shape(name: str, S: int, D: int) -> None:
    """Raise where K3 (``name`` "K3") or K4 ("K4") cannot take S keys of
    head dim D."""
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{name} takes D <= {MAX_HEAD_DIM} (got D={D}); wider heads are "
            "not ported (ROADMAP.md)")
    if name == "K4" and S > MAX_TILED_KEYS:
        raise NotImplementedError(
            f"K4 takes S <= {MAX_TILED_KEYS} (got S={S}); beyond "
            f"{MAX_TILED_KEYS} keys topk_attention takes the XLA path, as "
            "the JAX package does (attention.py: the fused engine's masked "
            "softmax, sparse_impl='gather', or the emulation engine, "
            "custom_tpu='ref')")


def _launch_split(name, wrapper, q, k_, v, bias, proj, kw):
    """Check and launch K3 (``name`` "K3") or K4 ("K4"): the pre-pass that
    quantizes each (row, head) cell's K side once into a workspace this
    function allocates, then the attention kernel (at block 32; the blocks
    kernel at the other blocks)."""
    (B, H, N, S, D), brow, pmat = _split_operands(name, q, k_, v, bias, proj,
                                                  kw)
    check_split_shape(name, S, D)
    out = torch.empty(B, H, N, D, dtype=kw["out_dtype"], device=q.device)
    if kw["block_size"] == 32:
        _launch_split_32(name, q, k_, v, brow, pmat, out, kw)
    else:
        _launch_blocks(name, 2, (q, k_, v), brow, pmat, out,
                       (B, H, N, S, D, 0, 0), kw)
    _count(wrapper, q, k_, bias, pmat, kw)
    return out


def _launch_split_32(name, q, k_, v, brow, pmat, out, kw):
    """Launch K3 or K4 at block 32 into ``out`` (``_launch_split``)."""
    tiled = int(name == "K4")
    B, H, N, D = q.shape
    S = k_.shape[2]
    args = _launch_args(kw)
    topk, approx, pred = args[0], args[2], args[3]
    part = _split_library(0).topk_attention_split_part(
        S, topk, approx, pred, args[8])
    if part < 0:
        raise ValueError(f"{name} takes no call with {kw}")
    lib = _split_library(part)
    if lib.topk_attention_split_smem_bytes(
            N, S, D, topk, approx, pred, args[4], args[5], args[8],
            tiled) == 0:
        raise ValueError(f"{name} cannot take N={N}, S={S}, D={D}")
    ws = torch.empty(lib.topk_attention_split_workspace_bytes(
        B, H, S, D, topk, approx, pred, args[5], args[8]), dtype=torch.uint8,
        device=q.device)
    bits = 0 if pmat is None else pmat.shape[0]
    cos = None if pmat is None else _elsa_cos_table(bits, q.device)
    with torch.cuda.device(q.device):
        err = lib.topk_attention_split(
            q.data_ptr(), k_.data_ptr(), v.data_ptr(),
            None if brow is None else brow.data_ptr(),
            None if pmat is None else pmat.data_ptr(),
            None if cos is None else cos.data_ptr(), ws.data_ptr(),
            out.data_ptr(), B, H, N, S, D, int(q.dtype == torch.bfloat16),
            int(kw["out_dtype"] == torch.bfloat16), *args, bits, tiled,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def fused_topk_attention_tiled(q: torch.Tensor, k_: torch.Tensor,
                               v: torch.Tensor, bias=None, proj=None, *,
                               k: int, scale: float, block_size: int = 32,
                               mbits: int = 8, scale_bits: int = 8,
                               approx: bool = True,
                               pred_mode: str = "ex_pred",
                               key_bits: int = 32, out_dtype=torch.float32,
                               bfloat: int = 0, flush: bool = False,
                               ebits: int = 0, emax: int = 0,
                               max_norm: float = 0.0,
                               contract: str = "exact") -> torch.Tensor:
    """``fused_topk_attention``'s function through K4 at any shape it takes
    (S <= MAX_TILED_KEYS, D <= MAX_HEAD_DIM), short sequences included; the
    plain version on CPU tensors.  K4 streams each cell's quantized K side
    from the workspace in key chunks, a block per group of query tiles."""
    kw = dict(k=k, scale=scale, block_size=block_size, mbits=mbits,
              scale_bits=scale_bits, approx=approx, pred_mode=pred_mode,
              key_bits=key_bits, out_dtype=out_dtype, bfloat=bfloat,
              flush=flush, ebits=ebits, emax=emax, max_norm=max_norm,
              contract=contract)
    if q.device.type == "cpu":
        return fused_topk_attention_ref(q, k_, v, bias, proj, **kw)
    return _launch_split("K4", fused_topk_attention_tiled, q, k_, v, bias,
                         proj, kw)


# launches, and launches per call site: (q shape, k shape, dtype, bias
# shape or None, projection shape or None, keyword arguments)
fused_topk_attention.launches = 0
fused_topk_attention.sites = collections.Counter()
fused_topk_attention_tiled.launches = 0
fused_topk_attention_tiled.sites = collections.Counter()
