"""MX-quantized linear, matmul and bmm (port of the JAX package's
``ops/linear.py``).

Two engines, chosen as JAX chooses them (``fastquant.fused_eligible``):
  * the fast path (``custom_tpu="fused"`` at the kernels' formats): the
    activation quantize is kernel K1 on the card, the weight quantize and
    products are plain torch;
  * the emulation engine (``custom_tpu="ref"``, and the fused engine's
    fallbacks): the operands elementwise-quantized (bfloat / fp), MX-
    quantized along the contraction axis by ``ops/mx.py``, multiplied by
    ``mx_dot``, and the output elementwise-quantized.

The int grids' products take bf16 operands (every int MX grid point is
exact in bf16) and must give the exact f32 product: the half-away bfloat
round is applied to the f32 result afterwards.  A bf16 GEMM that writes
bf16 would round half to even instead, so the card asks cuBLAS for an f32
output (``torch.mm(..., out_dtype=f32)``); the CPU, and every batched
product, upcasts both operands to f32, whose products are exact.  The
float grids' products are full f32 (TF32 must be off, as it is by
default).

The backward is JAX's custom VJP, as ``torch.autograd.Function``s
(``MxLinear``, ``MxMatmul``), taken where autograd records the call (grad
enabled and an input that requires grad); elsewhere the forward runs alone.
It is the reference's "madtile" scheme, each operand MX-quantized by the
emulation engine (``ops/mx.py``) along its own axis: for the linear's
weight gradient the input and the output gradient along the token axis
(-2), for its input gradient the weight along its output axis (0) and the
output gradient along -1; every result elementwise-rounded by the
backward specs (``specs.backwards()``, which strip all quantization when
``quantize_backprop`` is off).  The forward saves what JAX saves: the
bfloat-rounded operands under ``quantize_backprop``, else the raw ones.
"""

from __future__ import annotations

import torch

from ..specs import mx_assert_test
from .elemwise import quantize_elemwise_op
from .fastquant import (bf_fast, fused_eligible, gelu_quantize_serving,
                        quantize_mx_fast, quantize_mx_serving)
from .kernels import records_grad
from .mx import quantize_mx_op

_INT_FMTS = ("int8", "int4", "int2")


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (..., K) @ b (N, K).T`` with bf16 operands and an f32 result."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.device.type == "cuda":
        out = torch.mm(a2, b.t(), out_dtype=torch.float32)
    else:
        out = torch.mm(a2.to(torch.float32), b.t().to(torch.float32))
    return out.reshape(*a.shape[:-1], b.shape[0])


def _linear_fwd_fast(x, w, b, specs, save: bool = False):
    bs = specs.block_size
    sb = specs.effective_scale_bits()
    fl = specs.mx_flush_fp32_subnorms
    if specs.prequantized_activations:
        qx = bf_fast(x, specs).to(torch.bfloat16)  # already on the MX grid
    else:
        # the bfloat elementwise round rides inside the quantize kernel
        qx = quantize_mx_serving(x, specs.a_elem_format, bs, sb, axis=-1,
                                 flush=fl, bfloat=specs.bfloat)
    if specs.prequantized_weights:
        qw = w.to(torch.bfloat16)  # already on the MX grid
    else:
        qw = quantize_mx_fast(bf_fast(w, specs), specs.w_elem_format, bs,
                              sb, axis=-1, flush=fl)
    out = bf_fast(mm_f32(qx, qw), specs)
    if b is not None:
        out = bf_fast(out + bf_fast(b, specs), specs)
    return out, _saved(x, w, specs, save)


def _saved(x, w, specs, save: bool, rounded=None):
    """The operands the backward takes, or None without ``save``: JAX
    saves them bfloat-rounded under ``quantize_backprop`` (``rounded``,
    the emulation path's own, else rounded here), else raw."""
    if not save:
        return None
    if not specs.quantize_backprop:
        return x, w
    return rounded or (bf_fast(x, specs), bf_fast(w, specs))


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision f32 product (TF32 must be off, as it is by default)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def mx_dot(a: torch.Tensor, b: torch.Tensor, fmt_a, fmt_b) -> torch.Tensor:
    """``a @ b`` with the precision JAX picks from the element formats: bf16
    operands and f32 accumulation where both are int formats (a 2-D ``b``
    on the card takes ``mm_f32``'s bf16 GEMM with an f32 output), else
    full f32.  Returns float32."""
    if fmt_a in _INT_FMTS and fmt_b in _INT_FMTS:
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if b.dim() == 2:
            return mm_f32(a, b.t())
    return f32_matmul(a, b)


def _linear_fwd(x, w, b, specs, save: bool = False):
    """The linear's forward -> (out, the operands its backward takes, or
    None without ``save``): the fast path where ``fused_eligible`` holds,
    else the emulation linear (elementwise then MX quantize of each operand
    along the contraction axis), as JAX chooses."""
    if fused_eligible(specs, specs.a_elem_format, specs.w_elem_format):
        return _linear_fwd_fast(x, w, b, specs, save)
    bf_x = quantize_elemwise_op(x, specs, round=specs.round_output)
    bf_w = quantize_elemwise_op(w, specs, round=specs.round_weight)
    bf_b = None if b is None else quantize_elemwise_op(
        b, specs, round=specs.round_weight)
    qx = quantize_mx_op(bf_x, specs, elem_format=specs.a_elem_format,
                        axes=[-1], round=specs.round_mx_output)
    if specs.prequantized_weights:
        qw = bf_w  # already on the MX grid (requantizing is idempotent)
    else:
        qw = quantize_mx_op(bf_w, specs, elem_format=specs.w_elem_format,
                            axes=[-1], round=specs.round_mx_output)
    out = mx_dot(qx, qw.t(), specs.a_elem_format, specs.w_elem_format)
    out = quantize_elemwise_op(out, specs, round=specs.round_output)
    if bf_b is not None:
        out = quantize_elemwise_op(out + bf_b, specs,
                                   round=specs.round_output)
    return out, _saved(x, w, specs, save, (bf_x, bf_w))


def _linear_bwd(specs, x, w, has_bias: bool, g, needs=(True, True, True)):
    """JAX ``_linear_bwd``: (grad_x, grad_w, grad_b) from the saved operands
    and the output gradient ``g``; a gradient whose ``needs`` entry is
    False is None and costs nothing (as JAX under jit drops an unused
    cotangent)."""
    bspecs = specs.backwards()
    out_dim, in_dim = w.shape
    g = quantize_elemwise_op(g, bspecs, round=bspecs.round_grad_input)
    grad_x = grad_w = grad_b = None

    if needs[1]:
        # grad_w: x and g quantized along the contraction (token) axis
        qex_x = quantize_mx_op(x, bspecs,
                               elem_format=bspecs.a_elem_format_bp, axes=[-2],
                               round=bspecs.round_mx_input_grad_weight)
        qex_g = quantize_mx_op(g, bspecs,
                               elem_format=bspecs.a_elem_format_bp_ex,
                               axes=[-2],
                               round=bspecs.round_mx_grad_output_grad_weight)
        grad_w = mx_dot(qex_g.reshape(-1, out_dim).t(),
                        qex_x.reshape(-1, in_dim), bspecs.a_elem_format_bp_ex,
                        bspecs.a_elem_format_bp)
        grad_w = quantize_elemwise_op(grad_w, bspecs,
                                      round=bspecs.round_grad_weight)

    if needs[0]:
        # grad_x: w quantized along its output axis (0), g along -1
        qos_w = quantize_mx_op(w, bspecs, elem_format=bspecs.w_elem_format_bp,
                               axes=[0],
                               round=bspecs.round_mx_weight_grad_input)
        qos_g = quantize_mx_op(g, bspecs,
                               elem_format=bspecs.a_elem_format_bp_os,
                               axes=[-1],
                               round=bspecs.round_mx_grad_output_grad_input)
        grad_x = mx_dot(qos_g, qos_w, bspecs.a_elem_format_bp_os,
                        bspecs.w_elem_format_bp)
        grad_x = quantize_elemwise_op(grad_x, bspecs,
                                      round=bspecs.round_grad_input)

    if has_bias and needs[2]:
        grad_b = quantize_elemwise_op(g.reshape(-1, out_dim).sum(0), bspecs,
                                      round=bspecs.round_grad_weight)
    return grad_x, grad_w, grad_b


class MxLinear(torch.autograd.Function):
    """JAX ``mx_linear``: the quantized forward and its custom VJP."""

    @staticmethod
    def forward(ctx, x, w, b, specs):
        out, saved = _linear_fwd(x, w, b, specs, save=True)
        ctx.save_for_backward(*saved)
        ctx.specs, ctx.has_bias = specs, b is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*_linear_bwd(ctx.specs, x, w, ctx.has_bias, g,
                             ctx.needs_input_grad[:3]), None)


def linear(x, w, b=None, mx_specs=None):
    """``x @ w.T + b``.  ``mx_specs=None`` runs the unquantized linear in
    full f32 (TF32 must be off, as it is by default) with JAX's output
    dtype, under plain autograd; otherwise the fast path where
    ``fused_eligible`` holds, else the emulation engine, as in JAX, with
    JAX's custom backward (``MxLinear``) where autograd records."""
    mx_assert_test(mx_specs)
    if mx_specs is None:
        out_dtype = torch.result_type(x, w)
        out = torch.matmul(x.to(torch.float32),
                           w.to(torch.float32).t()).to(out_dtype)
        return out if b is None else out + b
    if records_grad(x, w, b):
        return MxLinear.apply(x, w, b, mx_specs)
    return _linear_fwd(x, w, b, mx_specs)[0]


def _fmt(specs, which):
    return specs.a_elem_format if which == "a" else specs.w_elem_format


def _fmt_bp(specs, which):
    return specs.a_elem_format_bp if which == "a" else specs.w_elem_format_bp


def _matmul_fwd(a, b, specs, mode_config, save: bool = False):
    """``a @ b`` with operand a MX-quantized along -1 and b along -2, each
    in the format ``mode_config`` names ("a" activation, "w" weight) ->
    (out, the operands its backward takes, or None without ``save``)."""
    assert mode_config in ("aa", "aw", "wa")
    fmt1 = _fmt(specs, mode_config[0])
    fmt2 = _fmt(specs, mode_config[1])
    if fused_eligible(specs, fmt1, fmt2):
        return _matmul_fwd_fast(a, b, specs, fmt1, fmt2, save)
    bf_a = quantize_elemwise_op(a, specs, round=specs.round_output)
    bf_b = quantize_elemwise_op(b, specs, round=specs.round_output)
    qa = quantize_mx_op(bf_a, specs, elem_format=fmt1, axes=[-1],
                        round=specs.round_mx_output)
    qb = quantize_mx_op(bf_b, specs, elem_format=fmt2, axes=[-2],
                        round=specs.round_mx_output)
    out = mx_dot(qa, qb, fmt1, fmt2)
    out = quantize_elemwise_op(out, specs, round=specs.round_output)
    return out, _saved(a, b, specs, save, (bf_a, bf_b))


def _matmul_fwd_fast(a, b, specs, fmt1, fmt2, save: bool = False):
    """The fast matmul: operand a through the activation quantize (K1 on
    the card along a last axis of whole blocks), b quantized along -2."""
    bs = specs.block_size
    sb = specs.effective_scale_bits()
    fl = specs.mx_flush_fp32_subnorms
    qa = quantize_mx_serving(a, fmt1, bs, sb, axis=-1, flush=fl,
                             bfloat=specs.bfloat)
    qb = quantize_mx_fast(bf_fast(b, specs), fmt2, bs, sb, axis=-2,
                          flush=fl)
    return bf_fast(f32_matmul(qa, qb), specs), _saved(a, b, specs, save)


def _matmul_bwd(specs, mode_config, a, b, g, needs=(True, True)):
    """JAX ``_matmul_bwd``: (grad_a, grad_b), the broadcast batch axes of
    a 2-D operand's gradient summed away; a gradient whose ``needs`` entry
    is False is None and costs nothing."""
    bspecs = specs.backwards()
    fmt1 = _fmt_bp(bspecs, mode_config[0])
    fmt2 = _fmt_bp(bspecs, mode_config[1])
    fmt_g = bspecs.a_elem_format_bp_os
    rnd = bspecs.round_mx_input_grad_input
    rnd_g = bspecs.round_mx_grad_output_grad_input
    g = quantize_elemwise_op(g, bspecs, round=bspecs.round_grad_input)
    grad_a = grad_b = None
    if needs[0]:
        qb = quantize_mx_op(b, bspecs, elem_format=fmt2, axes=[-1], round=rnd)
        qg1 = quantize_mx_op(g, bspecs, elem_format=fmt_g, axes=[-1],
                             round=rnd_g)
        grad_a = quantize_elemwise_op(
            mx_dot(qg1, qb.transpose(-1, -2), fmt_g, fmt2), bspecs,
            round=bspecs.round_grad_input)
        if grad_a.dim() > a.dim():
            grad_a = grad_a.reshape(-1, *a.shape).sum(0)
    if needs[1]:
        qa = quantize_mx_op(a, bspecs, elem_format=fmt1, axes=[-2], round=rnd)
        qg2 = quantize_mx_op(g, bspecs, elem_format=fmt_g, axes=[-2],
                             round=rnd_g)
        grad_b = quantize_elemwise_op(
            mx_dot(qa.transpose(-1, -2), qg2, fmt1, fmt_g), bspecs,
            round=bspecs.round_grad_input)
        if grad_b.dim() > b.dim():
            grad_b = grad_b.reshape(-1, *b.shape).sum(0)
    return grad_a, grad_b


class MxMatmul(torch.autograd.Function):
    """JAX ``mx_matmul``: the quantized forward and its custom VJP."""

    @staticmethod
    def forward(ctx, a, b, specs, mode_config):
        out, saved = _matmul_fwd(a, b, specs, mode_config, save=True)
        ctx.save_for_backward(*saved)
        ctx.specs, ctx.mode_config = specs, mode_config
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (*_matmul_bwd(ctx.specs, ctx.mode_config, a, b, g,
                             ctx.needs_input_grad[:2]), None, None)


def _mx_matmul(a, b, specs, mode_config):
    if records_grad(a, b):
        return MxMatmul.apply(a, b, specs, mode_config)
    return _matmul_fwd(a, b, specs, mode_config)[0]


def matmul(a, b, bias=None, mx_specs=None, mode_config="aa"):
    """``a @ b`` (reference matmul.py:211-222); ``bias`` follows addmm."""
    mx_assert_test(mx_specs)
    if mx_specs is None:
        out = f32_matmul(a, b).to(torch.result_type(a, b))
        return out if bias is None else out + bias
    out = _mx_matmul(a, b, mx_specs, mode_config)
    if bias is not None:
        bf_bias = quantize_elemwise_op(bias, mx_specs,
                                       round=mx_specs.round_weight)
        out = quantize_elemwise_op(out + bf_bias, mx_specs,
                                   round=mx_specs.round_output)
    return out


def bmm(a, b, mx_specs=None):
    """Batched matmul; both operands take a_elem_format (reference
    bmm.py:40-53)."""
    mx_assert_test(mx_specs)
    if mx_specs is None:
        return f32_matmul(a, b).to(torch.result_type(a, b))
    return _mx_matmul(a, b, mx_specs, "aa")


def gelu_erf(h: torch.Tensor) -> torch.Tensor:
    """The erf-form GELU as ``jax.nn.gelu(approximate=False)`` spells it,
    ``0.5 * h * erfc(-h * sqrt(1/2))`` (``F.gelu`` takes ``erf``, which
    rounds differently)."""
    return 0.5 * h * torch.erfc(-h * 0.7071067811865476)


def gelu_linear(h, w, b, mx_specs, fuse_gelu: bool, contract: str,
                approximate: bool = True):
    """``linear(GELU(h), w, b)``: the MLP's second half in DiT and PixArt
    blocks (tanh form) and DeiT blocks (``approximate=False``: the erf
    form).  With ``fuse_gelu`` in the serving tier the GELU rides in the
    linear's input quantize (``gelu_quantize_serving``, kernel K6) where its
    gate holds, and the linear takes that output as prequantized; else the
    unfused GELU, as the JAX package does."""
    hq = None
    if (fuse_gelu and mx_specs is not None and contract == "serving"
            and not mx_specs.quantize_backprop
            and fused_eligible(mx_specs, mx_specs.a_elem_format,
                               mx_specs.w_elem_format)):
        hq = gelu_quantize_serving(h, mx_specs, approximate=approximate)
    if hq is None:
        g = (torch.nn.functional.gelu(h, approximate="tanh") if approximate
             else gelu_erf(h))
        return linear(g, w, b, mx_specs=mx_specs)
    return linear(hq.to(h.dtype), w, b,
                  mx_specs=mx_specs.replace(prequantized_activations=True))
