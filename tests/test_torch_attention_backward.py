"""The port's attention backward against the JAX package's: the kernel
entries' surrogate VJPs (``_FusedQkvAttention`` for the qkv entry,
``_SplitKernelAttention`` for the split entry with a key bias) against
JAX's ``_fused_qkv_ad_bwd`` / ``_fused_ad_bwd`` on the same saved inputs
and output gradient, top-k and dense (an excluded block's k = N), in
ex_pred and two_step, on both engines; ``topk_attention``'s XLA branches
(the ref engine's scatter, its dense softmax, the fused engine's masked
softmax) against ``jax.grad``; and one tiny case on the fused engine end to
end, where JAX runs its Pallas kernel in interpret mode.  "gather" has no
backward: JAX's gradient through its quantizers is zero, and the port
raises.

Tolerances: as the linear's (tests/test_torch_backward.py): 2e-5 relative
and absolute at bfloat 0; at bfloat 16 at least 99% of the elements
bit-equal and none more than one bf16 step apart.  The surrogate's
probabilities go through exp, whose last bit torch and XLA may round
differently; where that moves an MX grid point of the PV product's
probability operand, the gradients of that row move by a grid step.  None
of these seeded inputs does (the bounds hold on every element).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.attention as jax_attention
from mx_quantization_tpu.specs import finalize_mx_specs as jax_finalize

from mx_quantization_tpu_torch.attention import (TopKAttentionConfig,
                                                 fused_qkv_topk_attention,
                                                 topk_attention)
from mx_quantization_tpu_torch.specs import finalize_mx_specs

B, H, N, S, D = 2, 2, 64, 40, 32
MODES = ["ex_pred", "two_step_leading_ones"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread keeps the module's cost its own
    when the suite runs several processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(engine, bfloat=16):
    d = dict(w_elem_format="int8", a_elem_format="int8", scale_bits=8,
             shared_exp_method="max", block_size=32, bfloat=bfloat, fp=0,
             round="nearest", quantize_backprop=True, custom_tpu=engine)
    return finalize_mx_specs(d), jax_finalize(d)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(True)


def _close(got, want, bfloat):
    got, want = got.detach().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if bfloat == 16:
        assert (got == want).mean() >= 0.99
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _cfgs(mode, topk, n):
    cfg = TopKAttentionConfig(k=12, pred_mode=mode, top_k=topk)
    jcfg = jax_attention.TopKAttentionConfig(k=12, pred_mode=mode,
                                             top_k=topk)
    if not topk:  # the entries' dense normalization (k = N, no predictor)
        jcfg = jcfg._replace(top_k=True, approx_flag=False, k=n)
    return cfg, jcfg


@pytest.mark.parametrize("engine", ["ref", "fused"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("topk", [True, False])
def test_qkv_entry_grad_matches_jax_surrogate(engine, mode, topk):
    specs, jspecs = _specs(engine)
    cfg, jcfg = _cfgs(mode, topk, N)
    qkv, g = _rand((B, N, 3 * H * D), 1), _rand((B, N, H * D), 2)
    (want,) = jax.jit(lambda x, g: jax_attention._fused_qkv_ad_bwd(
        H, D ** -0.5, jspecs, jcfg, (x,), g))(jnp.asarray(qkv),
                                             jnp.asarray(g))
    x = _t(qkv)
    out = fused_qkv_topk_attention(x, H, D ** -0.5, specs, cfg)
    (out * torch.from_numpy(g)).sum().backward()
    _close(x.grad, want, 16)


@pytest.mark.parametrize("engine", ["ref", "fused"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("topk", [True, False])
def test_split_entry_grad_matches_jax_surrogate(engine, mode, topk):
    """Cross attention (S != N) with a per-key mask bias, the bias's
    gradient included; the kernel entry is the fused engine's, so the port
    takes it through ``topk_attention`` there and through the Function
    itself on the ref engine."""
    specs, jspecs = _specs(engine)
    cfg, jcfg = _cfgs(mode, topk, S)
    q, k, v = _rand((B, H, N, D), 3), _rand((B, H, S, D), 4), \
        _rand((B, H, S, D), 5)
    bias = np.where(np.arange(S) < S - 7, 0.0, -1e4).astype(np.float32)
    bias = np.broadcast_to(bias, (B, 1, 1, S)).copy()
    bias[1, ..., :3] += _rand((3,), 6)
    g = _rand((B, H, N, D), 7)
    want = jax.jit(lambda q, k, v, bias, g: jax_attention._fused_ad_bwd(
        D ** -0.5, jspecs, jcfg, (q, k, v, bias, None), g))(
            *map(jnp.asarray, (q, k, v, bias, g)))
    xs = [_t(a) for a in (q, k, v, bias)]
    if engine == "fused":
        out, _ = topk_attention(*xs[:3], D ** -0.5, specs, cfg, bias=xs[3])
    else:
        from mx_quantization_tpu_torch.attention import _SplitKernelAttention
        out = _SplitKernelAttention.apply(*xs, None, D ** -0.5, specs,
                                          cfg._replace(**jcfg._asdict()))
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip(xs[:3], want[:3]):
        _close(got.grad, w, 16)
    # the bias's gradient sums the score gradients over heads and queries
    # in f32, with no bf16 round after it
    _close(xs[3].grad, want[3], 0)


@pytest.mark.parametrize("case", ["ref_topk", "ref_dense", "fused_masked"])
def test_xla_path_grads_match_jax(case):
    """The XLA branches under ``jax.grad``: the ref engine's top-k scatter
    (a key bias), its dense softmax, and the fused engine's masked
    softmax (a per-query bias, which no kernel takes), at bfloat 0."""
    engine = "fused" if case == "fused_masked" else "ref"
    specs, jspecs = _specs(engine, bfloat=0)
    topk = case != "ref_dense"
    cfg = TopKAttentionConfig(k=12, top_k=topk)
    jcfg = jax_attention.TopKAttentionConfig(k=12, top_k=topk)
    q, k, v = _rand((B, H, N, D), 8), _rand((B, H, N, D), 9), \
        _rand((B, H, N, D), 10)
    bias = _rand((B, 1, N, N) if engine == "fused" else (B, 1, 1, N), 11,
                 0.5)
    g = _rand((B, H, N, D), 12)

    def jf(q, k, v, bias):
        out, _ = jax_attention.topk_attention(q, k, v, D ** -0.5, jspecs,
                                              jcfg, bias=bias)
        return jnp.sum(out * g)
    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (q, k, v, bias)))
    xs = [_t(a) for a in (q, k, v, bias)]
    out, _ = topk_attention(*xs[:3], D ** -0.5, specs, cfg, bias=xs[3])
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip(xs, want):
        _close(got.grad, w, 0)


def test_fused_kernel_grad_end_to_end_tiny():
    """``jax.grad`` through JAX's qkv kernel entry (its Pallas kernel in
    interpret mode, the surrogate VJP) against ``loss.backward()`` through
    the port's (K2's plain version, the surrogate)."""
    specs, jspecs = _specs("fused")
    b, n, h, d = 1, 32, 1, 32
    qkv, g = _rand((b, n, 3 * h * d), 13), _rand((b, n, h * d), 14)
    cfg = TopKAttentionConfig(k=8)
    jcfg = jax_attention.TopKAttentionConfig(k=8)
    want = jax.jit(jax.grad(lambda x: jnp.sum(
        jax_attention.fused_qkv_topk_attention(x, h, d ** -0.5, jspecs,
                                               jcfg) * g)))(jnp.asarray(qkv))
    x = _t(qkv)
    out = fused_qkv_topk_attention(x, h, d ** -0.5, specs, cfg)
    (out * torch.from_numpy(g)).sum().backward()
    _close(x.grad, want, 16)


def test_gather_has_no_backward():
    """JAX's gradient through "gather" is zero (its quantizers' derivative
    through the bit casts); the port raises rather than return it."""
    specs, jspecs = _specs("ref", bfloat=0)
    cfg = TopKAttentionConfig(k=8, sparse_impl="gather")
    jcfg = jax_attention.TopKAttentionConfig(k=8, sparse_impl="gather")
    q = _rand((B, H, N, D), 15)
    want = jax.jit(jax.grad(lambda q: jnp.sum(jax_attention.topk_attention(
        q, q, q, 0.2, jspecs, jcfg)[0] ** 2)))(jnp.asarray(q))
    assert not np.asarray(want).any()
    x = _t(q)
    with pytest.raises(NotImplementedError, match="gather"):
        topk_attention(x, x, x, 0.2, specs, cfg)
    with torch.no_grad():  # the forward alone still runs
        topk_attention(x, x, x, 0.2, specs, cfg)
