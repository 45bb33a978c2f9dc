"""Quantized attention with approximated top-k pruning (port of the JAX
package's ``attention.py``: ``TopKAttentionConfig``, ``topk_attention``,
``fused_qkv_eligible`` and ``fused_qkv_topk_attention``).

The flow is the reference's
  true_scores = MX(q) @ MX(k)^T * scale (+ bias),
  pred = approx(q) @ approx(k)^T (+ bias),
  attn = softmax over the top-k of pred,  out = MX(attn) @ MX(v),
inside one kernel where JAX takes its Pallas kernels: K2
(``fused_qkv_topk_attention``, self-attention from the fused qkv output,
N <= 512) or K3 / K4 (``topk_attention``, split q/k/v with an optional key
bias; K4 where N or S exceeds 512), all in ``ops/kernels/topk_attention.py``.
Each takes every predictor of the JAX kernel it replaces: K2 (and K7, DiT's
split-emission entry) every one but ELSA, K3 and K4 ELSA too, with the
structured orthogonal projection (``predictors/elsa.py``) unless the caller
passes its own.

Everywhere else the XLA path runs, in plain torch as in JAX: the emulation
engine (``custom_tpu="ref"``), and the fused engine's fallbacks
(``sparse_impl="gather"``, S > 4096, fp != 0, another bias shape, a
non-kernel format, non-square ELSA).  The ref engine selects by
``jax.lax.top_k``'s order and scatters (``_sparse_softmax_scatter``); the
fused fallback masks with an exact k-th value (``_sparse_softmax_threshold``);
"gather" multiplies the selected V rows only.  The serving contract is a
kernel tier: where a config leaves the kernels it raises ``ValueError``, as
JAX does.

The kernels have no backward, in JAX as here.  Where autograd records, each
kernel entry is a ``torch.autograd.Function`` whose backward rematerializes
the XLA path's equivalent (``_xla_topk_dense``, the threshold mask) on the
saved inputs and differentiates it, as JAX's custom VJPs do; its products
are the quantized ``matmul``'s, so their MX backward applies.  The
selector feeds only comparisons and carries no gradient (JAX's cotangent
there is zero), so it is computed without autograd.  The "gather" path has
no backward (JAX's gradient through its quantizers is zero), so it raises
where autograd records.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .formats import format_params
from .ops.elemwise import quantize_elemwise_op
from .ops.fastquant import fused_eligible
from .ops.kernels import records_grad
from .ops.kernels.topk_attention import (MAX_TILED_KEYS, MAX_TOKENS,
                                         QKV_PRED_MODES, fused_topk_attention,
                                         fused_topk_attention_qkv)
from .ops.linear import f32_matmul, matmul
from .ops.mx import quantize_mx_op
from .ops.selection import kth_largest, top_k_indices
from .predictors.elsa import ElsaApproximation
from .predictors.elsa import orthogonal_matrix as _structured_matrix
from .predictors.exponent import exponent_predict


class TopKAttentionConfig(NamedTuple):
    """Attention-pruning configuration (same fields as the JAX package's).

    key_bits: ranking precision of the top-k selection (32 exact f32, 16
    bf16-precision, 8 sign+exponent).  out_dtype: "float32" or "bfloat16"
    output of the kernel.  contract: "exact" keeps the emulation-ordered
    numerics; "serving" selects the relaxed tier (tie-inclusive selection,
    bf16 attention probabilities, no bf16 rounds of the score and PV
    sums)."""
    mx_quant: bool = True
    top_k: bool = True
    k: int = 20
    approx_flag: bool = True
    pred_mode: str = "ex_pred"
    sparse_impl: str = "dense"
    key_bits: int = 32
    out_dtype: str = "float32"
    contract: str = "exact"


# the exponent-family predictors of the JAX kernels, which K2 and K7 take
# (K3 and K4 take ELSA too, gated separately: square attention only)
_KERNEL_PRED_MODES = QKV_PRED_MODES
# element formats the kernels quantize (every grid point is exact in bf16)
_KERNEL_ELEM_FORMATS = ("int8", "int4", "int2", "fp8_e4m3", "fp8_e5m2",
                        "fp6_e3m2", "fp6_e2m3", "fp4", "fp4_e2m1")
_KERNEL_BFLOATS = (0, 16, 32)


def _kernel_format_args(mx_specs) -> dict:
    """mbits/ebits/emax/max_norm kernel knobs for a_elem_format."""
    ebits, mbits, emax, max_norm, _ = format_params(mx_specs.a_elem_format)
    return dict(mbits=mbits, ebits=ebits, emax=emax, max_norm=float(max_norm))


def _kernel_elemwise_args(mx_specs) -> dict:
    """The kernels' elementwise-quantization knobs from the specs (bfloat=32
    is the identity on f32 and reaches the kernels as 0)."""
    return dict(bfloat=16 if mx_specs.bfloat == 16 else 0,
                flush=mx_specs.mx_flush_fp32_subnorms)


def _kernel_specs_ok(mx_specs, cfg: TopKAttentionConfig) -> bool:
    return (mx_specs.custom_tpu == "fused" and cfg.sparse_impl == "dense"
            and mx_specs.a_elem_format in _KERNEL_ELEM_FORMATS
            and mx_specs.bfloat in _KERNEL_BFLOATS and mx_specs.fp == 0)


def _bias_ok(bias, q: torch.Tensor, S: int) -> bool:
    """A per-key additive mask row (B, 1, 1, S): the PixArt cross-attention
    contract; the kernels take no other bias shape."""
    return bias is None or (bias.dim() == 4 and tuple(bias.shape[1:3]) ==
                            (1, 1) and bias.shape[0] == q.shape[0]
                            and bias.shape[3] == S)


def fused_qkv_eligible(mx_specs, cfg: TopKAttentionConfig, n: int) -> bool:
    """Can self-attention run on the fused qkv entry (K2)?  The JAX
    package's gate: N <= MAX_TOKENS (512), the kernels' formats and
    bfloats, and every predictor but ELSA (or none); other self-attention
    takes the split entry (K3 or K4) through ``topk_attention``."""
    return (mx_specs is not None and cfg.mx_quant
            and _kernel_specs_ok(mx_specs, cfg)
            and n <= MAX_TOKENS and mx_specs.block_size == 32
            and (cfg.pred_mode in _KERNEL_PRED_MODES
                 or not cfg.approx_flag))


def split_t_eligible(mx_specs, cfg: TopKAttentionConfig, n: int) -> bool:
    """Does DiT's ``qkv_layout="split_t"`` take the split-emission entry
    (K7)?  The JAX package's gate: N % 128 == 0, its fused qkv entry's
    conditions (``fused_qkv_eligible``) and the fast path's formats."""
    return (n % 128 == 0
            and fused_qkv_eligible(mx_specs, cfg, n)
            and fused_eligible(mx_specs, mx_specs.a_elem_format,
                               mx_specs.w_elem_format))


def fused_qkv_topk_attention(qkv: torch.Tensor, num_heads: int, scale: float,
                             mx_specs, cfg: TopKAttentionConfig
                             ) -> torch.Tensor:
    """(B, N, 3*H*D) fused-qkv activations -> (B, N, H*D).  A cfg with
    top_k=False (an excluded block or timestep) runs dense MX attention:
    it is normalized to k = N so the kernel takes its masked-softmax
    branch.  Where autograd records, the backward is the surrogate's
    (``_FusedQkvAttention``)."""
    if not cfg.top_k:
        cfg = cfg._replace(top_k=True, approx_flag=False, k=int(qkv.shape[1]))
    if records_grad(qkv):
        return _FusedQkvAttention.apply(qkv, num_heads, scale, mx_specs, cfg)
    return _qkv_kernel(qkv, num_heads, scale, mx_specs, cfg)


def _qkv_kernel(qkv, num_heads, scale, mx_specs, cfg) -> torch.Tensor:
    """The fused qkv kernel entry (K2)."""
    return fused_topk_attention_qkv(
        qkv, num_heads, k=cfg.k, scale=scale,
        block_size=mx_specs.block_size,
        scale_bits=mx_specs.effective_scale_bits(), approx=cfg.approx_flag,
        pred_mode=cfg.pred_mode, key_bits=cfg.key_bits,
        out_dtype=getattr(torch, cfg.out_dtype), contract=cfg.contract,
        **_kernel_elemwise_args(mx_specs), **_kernel_format_args(mx_specs))


def _split_kernel(q, k, v, bias, scale, mx_specs, cfg,
                  proj=None) -> torch.Tensor:
    """The split kernel entry (K3, or K4 for N or S over 512) where the JAX
    package takes its kernel; ``proj`` is ELSA's projection."""
    return fused_topk_attention(
        q, k, v, bias, proj, k=cfg.k, scale=scale,
        block_size=mx_specs.block_size,
        scale_bits=mx_specs.effective_scale_bits(), approx=cfg.approx_flag,
        pred_mode=cfg.pred_mode, key_bits=cfg.key_bits,
        out_dtype=getattr(torch, cfg.out_dtype), contract=cfg.contract,
        **_kernel_elemwise_args(mx_specs), **_kernel_format_args(mx_specs))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in its order of operations."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def predict_scores(q, k, mx_specs, pred_mode: str, orthogonal_matrix=None):
    """Approximated Q.K^T scores for the top-k selection.  The predictor
    operands are signs times powers of two (exact in bf16): the fused
    engine multiplies them as bf16 with f32 accumulation, the ref engine
    in full f32, as JAX does."""
    if pred_mode == "ELSA":
        return ElsaApproximation(q, k, mx_specs,
                                 orthogonal_matrix).approximation_scores()
    aq, ak = exponent_predict(q, k, mx_specs, pred_mode)
    if mx_specs.custom_tpu == "fused":
        aq, ak = aq.to(torch.bfloat16), ak.to(torch.bfloat16)
    return f32_matmul(aq, ak.transpose(-1, -2))


def _sparse_softmax_scatter(true_scores, idx):
    """Softmax over the gathered top-k values, scattered back dense
    (reference main.py:147-148)."""
    p = _softmax(torch.gather(true_scores, -1, idx))
    return torch.zeros_like(true_scores).scatter(-1, idx, p)


def _topk_mask(scores, k: int):
    """Boolean mask of each row's top-k entries with ``jax.lax.top_k``'s
    tie order (lowest index first), without a sort: the k-th value by the
    bit-space bisection (``ops/selection.py``), ties at it ranked by a
    cumulative count."""
    kth = kth_largest(scores, k)[..., None]
    gt = scores > kth
    n_gt = gt.sum(-1, keepdim=True, dtype=torch.int32)
    eq = scores == kth
    eq_rank = torch.cumsum(eq.to(torch.int32), dim=-1)
    return gt | (eq & (eq_rank <= k - n_gt))


def _sparse_softmax_threshold(true_scores, pred_scores, k: int):
    """Dense top-k-masked softmax: the entries top_k(pred) + gather +
    scatter select, with elementwise ops only (JAX's fused fallback)."""
    sel = _topk_mask(pred_scores, k)
    neg = torch.finfo(true_scores.dtype).min
    masked = torch.where(sel, true_scores, neg)
    m = masked.amax(-1, keepdim=True)
    e = torch.where(sel, torch.exp(true_scores - m), 0.0)
    return e / e.sum(-1, keepdim=True)


def _true_scores(q, k, scale, mx_specs, bias):
    s = matmul(q, k.transpose(-1, -2), mx_specs=mx_specs,
               mode_config="aa") * scale
    return s if bias is None else s + bias


def _selector(q, k, true_scores, mx_specs, cfg, bias, orthogonal_matrix):
    """The scores the top-k ranks: the predictor's (plus the bias), or the
    true scores without approx_flag; without autograd, as they feed only
    comparisons."""
    if not cfg.approx_flag:
        return true_scores.detach()
    with torch.no_grad():
        pred = predict_scores(q, k, mx_specs, cfg.pred_mode,
                              orthogonal_matrix)
        return pred if bias is None else pred + bias


def _xla_topk_dense(q, k, v, scale, mx_specs, cfg, bias=None,
                    orthogonal_matrix=None):
    """The XLA path's equivalent of the kernels (dense sparse_impl, the
    threshold mask): JAX's differentiation surrogate of its kernel."""
    true_scores = _true_scores(q, k, scale, mx_specs, bias)
    selector = _selector(q, k, true_scores, mx_specs, cfg, bias,
                         orthogonal_matrix)
    attn = _sparse_softmax_threshold(true_scores, selector, cfg.k)
    return matmul(attn, v, mx_specs=mx_specs, mode_config="aa")


def _surrogate_vjp(ctx, fn, g):
    """The gradients of ``fn`` at the saved inputs against the output
    gradient ``g``: JAX's ``jax.vjp`` of the surrogate, for the inputs that
    need one (None for the rest)."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(n)
              for t, n in zip(saved, need)]
        out = fn(*xs)
        wrt = [x for x, n in zip(xs, need) if n]
        grads = iter(torch.autograd.grad(out, wrt, g.to(out.dtype),
                                         allow_unused=True))
    return [next(grads) if n else None for n in need]


class _FusedQkvAttention(torch.autograd.Function):
    """K2's forward; the backward differentiates ``_xla_topk_dense`` on the
    qkv activations split as JAX's ``_fused_qkv_ad_bwd`` splits them."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, mx_specs, cfg):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, scale, mx_specs, cfg)
        return _qkv_kernel(qkv, num_heads, scale, mx_specs, cfg)

    @staticmethod
    def backward(ctx, g):
        H, scale, mx_specs, cfg = ctx.args

        def f(qkv):
            B, N, F = qkv.shape
            D = F // (3 * H)
            q, k, v = (t.contiguous() for t in
                       qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4))
            out = _xla_topk_dense(q, k, v, scale, mx_specs, cfg)
            return out.transpose(1, 2).reshape(B, N, H * D)

        return (*_surrogate_vjp(ctx, f, g), None, None, None, None)


class _SplitKernelAttention(torch.autograd.Function):
    """K3 / K4's forward; the backward differentiates ``_xla_topk_dense``
    with the same bias and projection (JAX ``_fused_ad_bwd``).  ELSA's
    projection gets a zero gradient, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, bias, proj, scale, mx_specs, cfg):
        ctx.save_for_backward(q, k, v, bias)
        ctx.args = (proj, scale, mx_specs, cfg)
        return _split_kernel(q, k, v, bias, scale, mx_specs, cfg, proj)

    @staticmethod
    def backward(ctx, g):
        proj, scale, mx_specs, cfg = ctx.args
        grads = _surrogate_vjp(
            ctx, lambda q, k, v, bias: _xla_topk_dense(
                q, k, v, scale, mx_specs, cfg, bias, proj), g)
        gproj = torch.zeros_like(proj) if ctx.needs_input_grad[4] else None
        return (*grads, gproj, None, None, None)


def _split_entry(q, k, v, bias, scale, mx_specs, cfg, proj=None):
    """The split kernel entry, with the surrogate's backward where autograd
    records."""
    if records_grad(q, k, v, bias, proj):
        return _SplitKernelAttention.apply(q, k, v, bias, proj, scale,
                                           mx_specs, cfg)
    return _split_kernel(q, k, v, bias, scale, mx_specs, cfg, proj)


def _gathered_sparse_attention(true_scores, idx, v, mx_specs):
    """O(N*k*D) sparse attention: the V rows at the selected indices.  The
    gathered probabilities are MX-quantized per row (one block grouping
    over the k values, within MX rounding of the dense layout), V along
    the key axis; the product takes bf16 operands with f32 accumulation."""
    p = _softmax(torch.gather(true_scores, -1, idx))
    p = quantize_elemwise_op(p, mx_specs, round=mx_specs.round_output)
    p = quantize_mx_op(p, mx_specs, elem_format=mx_specs.a_elem_format,
                       axes=[-1], round=mx_specs.round_mx_output)
    bf_v = quantize_elemwise_op(v, mx_specs, round=mx_specs.round_output)
    qv = quantize_mx_op(bf_v, mx_specs, elem_format=mx_specs.a_elem_format,
                        axes=[-2], round=mx_specs.round_mx_output)
    *lead, n, kk = idx.shape
    d = qv.shape[-1]
    vg = torch.gather(qv.unsqueeze(-3).expand(*lead, n, qv.shape[-2], d),
                      -2, idx.unsqueeze(-1).expand(*lead, n, kk, d))
    out = f32_matmul(p.to(torch.bfloat16).unsqueeze(-2),
                     vg.to(torch.bfloat16)).squeeze(-2)
    return quantize_elemwise_op(out, mx_specs, round=mx_specs.round_output)


def topk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, mx_specs, cfg: TopKAttentionConfig,
                   orthogonal_matrix=None,
                   bias: Optional[torch.Tensor] = None):
    """Attention for one (batch, heads, seq, dim) q and (batch, heads,
    keys, dim) k, v.  bias: optional additive mask (B, 1, 1, S), added to
    both the true and the predicted scores (the PixArt cross-attention
    contract).  ``orthogonal_matrix`` is ELSA's (bits, D) projection;
    without one, ELSA takes ``create_structured_orthogonal_matrix(D)``.
    Returns (out, idx): the selected indices (..., N, k) where JAX returns
    them (the ref engine's top-k and "gather"), else None."""
    if not cfg.mx_quant or mx_specs is None:
        dt = torch.promote_types(q.dtype, k.dtype)
        s = f32_matmul(q, k.transpose(-1, -2)).to(dt) * scale
        if bias is not None:
            s = s + bias
        p = torch.softmax(s.to(torch.float32), dim=-1).to(s.dtype)
        return f32_matmul(p, v).to(torch.promote_types(p.dtype, v.dtype)), None

    S = int(k.shape[-2])
    bias_ok = _bias_ok(bias, q, S)
    if not cfg.top_k:
        # dense (no-top-k) MX attention, the excluded-block / timestep path:
        # the kernel with k = S skips the selection
        if (_kernel_specs_ok(mx_specs, cfg) and bias_ok
                and S <= MAX_TILED_KEYS):
            dcfg = cfg._replace(top_k=True, approx_flag=False, k=S)
            return _split_entry(q, k, v, bias, scale, mx_specs, dcfg), None
        if cfg.contract == "serving":
            raise ValueError(
                "contract='serving' is a fused-kernel tier; this dense "
                "config falls back to the XLA path (unsupported bias shape, "
                "fp != 0, S > 4096, or a non-kernel element format)")
        attn = _softmax(_true_scores(q, k, scale, mx_specs, bias))
        return matmul(attn, v, mx_specs=mx_specs, mode_config="aa"), None

    # ELSA runs in the kernels for square attention only: the reference
    # takes the key norms at the QUERY index (JAX ``elsa_kernel_ok``)
    elsa_ok = cfg.pred_mode == "ELSA" and q.shape[-2] == S
    if (_kernel_specs_ok(mx_specs, cfg) and bias_ok
            and S <= MAX_TILED_KEYS
            and (cfg.pred_mode in _KERNEL_PRED_MODES or elsa_ok
                 or not cfg.approx_flag)):
        proj = None
        if cfg.approx_flag and cfg.pred_mode == "ELSA":
            proj = (orthogonal_matrix if orthogonal_matrix is not None else
                    _structured_matrix(int(q.shape[-1]), q.device))
        return _split_entry(q, k, v, bias, scale, mx_specs, cfg, proj), None
    if cfg.contract == "serving":
        raise ValueError(
            "contract='serving' is a fused-kernel tier; this config falls "
            "back to the XLA path (sparse_impl, bias shape, fp != 0, "
            "S > 4096, element format, or a non-kernel predictor)")

    # the XLA path (JAX computes the true scores and the selector before
    # its kernel test; under jit the kernel path drops them)
    true_scores = _true_scores(q, k, scale, mx_specs, bias)
    selector = _selector(q, k, true_scores, mx_specs, cfg, bias,
                         orthogonal_matrix)
    if cfg.sparse_impl == "dense":
        if mx_specs.custom_tpu == "fused":
            # the scatter-free masked softmax (the same selection)
            attn = _sparse_softmax_threshold(true_scores, selector, cfg.k)
            idx = None
        else:
            idx = top_k_indices(selector, cfg.k)
            attn = _sparse_softmax_scatter(true_scores, idx)
        out = matmul(attn, v, mx_specs=mx_specs, mode_config="aa")
    elif cfg.sparse_impl == "gather":
        if records_grad(q, k, v, bias):
            raise NotImplementedError(
                "sparse_impl='gather' has no backward (the JAX package's "
                "gradient through its quantizers is zero); train with "
                "sparse_impl='dense'")
        idx = top_k_indices(selector, cfg.k)
        out = _gathered_sparse_attention(true_scores, idx, v, mx_specs)
    else:
        raise ValueError(f"Unknown sparse_impl {cfg.sparse_impl!r}")
    return out, idx
