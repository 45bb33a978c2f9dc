"""The port's split q/k/v top-k attention (K3's plain version, and
``attention.topk_attention``'s dispatch) against the JAX package's
``fused_topk_attention`` in interpret mode.

Inputs are made with numpy from a seed: B = 2, H = 2, D = 72, N = 64 queries
and S = 64 or 40 keys, q and k scaled by 2 so that the MX blocks' exponents
vary (a two_step operand is e * (2^l1 + 2^l2) / 64 with e the block
exponent, so a block with e = 0 contributes nothing).  The tolerance is
tests/test_torch_attention.py's: every query row within rtol = atol = 2e-5
at f32 output, except rows whose attention probabilities, read through a
probe (every head's v set to the identity), differ from JAX's; such a row
may differ by at most two probabilities of one grid step each, and at most
one row in a hundred may flip.  The flips come from torch's and XLA's
float32 exp and from the order in which each sums the scores: the port
sums two_step predictor products in d order, XLA in its own order, and
because the two_step operand is cast to bf16 its products are not exact
per block, so the order can move a predicted score by an ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu import finalize_mx_specs
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import topk_attention as jax_topk
from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention as jax_kernel

from mx_quantization_tpu_torch.attention import (TopKAttentionConfig,
                                                 topk_attention)
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    MAX_ELSA_BITS, MAX_SPLIT_TOKENS, MAX_TILED_KEYS, fused_topk_attention,
    fused_topk_attention_qkv, fused_topk_attention_ref)
from mx_quantization_tpu_torch.specs import finalize_mx_specs as port_specs
from mx_quantization_tpu_torch.workloads.pixart import pixart_mx_specs
from test_torch_attention import check_rows

B, H, N, D = 2, 2, 64, 72
PIXART = dict(w_elem_format="int8", a_elem_format="int8", scale_bits=8,
              block_size=32, bfloat=32, mx_flush_fp32_subnorms=True,
              quantize_backprop=False, custom_tpu="fused")


def split_inputs(S, seed, with_bias, n=N, heads=H, b=B):
    rng = np.random.RandomState(seed)
    q = (2 * rng.randn(b, heads, n, D)).astype(np.float32)
    k = (2 * rng.randn(b, heads, S, D)).astype(np.float32)
    v = rng.randn(b, heads, S, D).astype(np.float32)
    bias = None
    if with_bias:  # caption masks of varying valid length, as PixArt's
        valid = np.arange(S)[None] < np.array([S - 9, S - 2])[:b, None]
        bias = ((1.0 - valid) * -10000.0).astype(np.float32)[:, None, None]
    return q, k, v, bias


def _probe(v):
    """v with every cell set to the identity (v[s, d] = s == d): query n's
    output row then holds the probabilities that meet v."""
    S = v.shape[2]
    assert v.shape[3] >= S
    return np.broadcast_to(np.eye(S, v.shape[3], dtype=v.dtype),
                           v.shape).copy()


def assert_split_matches_jax(port, jax_fn, q, k, v, bias, mbits=8,
                             contract="exact", out_bf16=False, block_size=32):
    """port, jax_fn: (q, k, v, bias) float32 arrays -> (B, H, N, D)."""
    S = k.shape[2]
    cells = q.shape[0] * q.shape[1]

    def run(fn, vv):
        return np.asarray(fn(q, k, vv, bias), np.float32).reshape(
            cells, q.shape[2], -1)

    got, want = run(port, v), run(jax_fn, v)
    pg, pw = run(port, _probe(v))[..., :S], run(jax_fn, _probe(v))[..., :S]
    vmax = np.abs(v).max(axis=(2, 3)).reshape(cells)
    check_rows(got, want, pg, pw, vmax, mbits, contract, out_bf16,
               block_size)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


MODES = {  # name: (k, keyword arguments)
    "two_step": (9, dict(pred_mode="two_step_leading_ones")),
    "ex_pred": (9, dict(pred_mode="ex_pred")),
    "approx_off": (9, dict(approx=False)),
    "dense": (None, dict()),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("S,with_bias", [(64, False), (40, True)])
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_plain_matches_jax_kernel(mode, S, with_bias, contract):
    k, extra = MODES[mode]
    q, kk, v, bias = split_inputs(S, seed=S + len(mode), with_bias=with_bias)
    kw = dict(k=S if k is None else k, scale=D ** -0.5, key_bits=32,
              flush=True, contract=contract, **extra)
    assert_split_matches_jax(
        lambda *a: fused_topk_attention_ref(*map(_t, a), **kw),
        lambda *a: jax_kernel(*map(_j, a), **kw), q, kk, v, bias,
        contract=contract)


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_subnormal_blocks_flush(contract):
    q, k, v, bias = split_inputs(40, seed=3, with_bias=True)
    k[0, 1, 5, :32] = 1e-39    # a k block of subnormals
    q[1, 0, 7, 32:64] = -2e-40
    v[0, 0, :32, 4] = 3e-39    # a v block (32 keys of one column)
    kw = dict(k=9, scale=D ** -0.5, key_bits=32, flush=True,
              pred_mode="two_step_leading_ones", contract=contract)
    assert_split_matches_jax(
        lambda *a: fused_topk_attention_ref(*map(_t, a), **kw),
        lambda *a: jax_kernel(*map(_j, a), **kw), q, k, v, bias,
        contract=contract)


def test_wrapper_uses_plain_only_on_cpu_and_keeps_its_domain():
    q, k, v, bias = map(_t, split_inputs(40, seed=4, with_bias=True))
    kw = dict(k=5, scale=0.125, pred_mode="two_step_leading_ones")
    before = fused_topk_attention.launches
    out = fused_topk_attention(q, k, v, bias, **kw)
    assert fused_topk_attention.launches == before  # nothing launched
    assert torch.equal(out, fused_topk_attention_ref(q, k, v, bias, **kw))
    meta = torch.empty(1, 1, 32, 72, device="meta")
    with pytest.raises(ValueError):
        fused_topk_attention(meta, meta, meta, k=5, scale=0.125)
    # every predictor of the TPU kernels is K3's; ELSA needs its projection,
    # at most MAX_ELSA_BITS rows of width D; K2 serves every one but ELSA
    with pytest.raises(ValueError, match="unknown pred_mode"):
        fused_topk_attention(q, k, v, k=5, scale=0.125, pred_mode="sanger")
    square = q[:, :, :40]
    with pytest.raises(ValueError, match="projection"):
        fused_topk_attention(square, k, v, k=5, scale=0.125, pred_mode="ELSA")
    with pytest.raises(NotImplementedError, match="bits"):
        fused_topk_attention(square, k, v, None, torch.zeros(MAX_ELSA_BITS + 1,
                                                             72),
                             k=5, scale=0.125, pred_mode="ELSA")
    with pytest.raises(NotImplementedError, match="split entry"):
        fused_topk_attention_qkv(torch.zeros(1, 32, 3 * 72), 1, k=5,
                                 scale=0.125, pred_mode="ELSA")


def _port_cfg(**kw):
    return TopKAttentionConfig(**kw)


def test_unquantized_branch_matches_jax():
    q, k, v, bias = split_inputs(40, seed=5, with_bias=True)
    got, idx = topk_attention(*map(_t, (q, k, v)), D ** -0.5, None,
                              _port_cfg(mx_quant=False), bias=_t(bias))
    want, _ = jax_topk(*map(_j, (q, k, v)), D ** -0.5, None,
                       JaxAttnConfig(mx_quant=False), bias=_j(bias))
    assert idx is None
    # full-f32 products summed in XLA's and torch's orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_dense_normalization_matches_jax(contract):
    """top_k=False (an excluded block): k = S, no predictor, with the
    PixArt cross-attention bias."""
    q, k, v, bias = split_inputs(40, seed=6, with_bias=True)
    cfg = dict(mx_quant=True, top_k=False, k=7, approx_flag=True,
               pred_mode="two_step_leading_ones", contract=contract)
    assert_split_matches_jax(
        lambda *a: topk_attention(*map(_t, a[:3]), D ** -0.5,
                                  pixart_mx_specs(), _port_cfg(**cfg),
                                  bias=_t(a[3]))[0],
        lambda *a: jax_topk(*map(_j, a[:3]), D ** -0.5,
                            finalize_mx_specs(PIXART), JaxAttnConfig(**cfg),
                            bias=_j(a[3]))[0], q, k, v, bias,
        contract=contract)
    # the normalization itself: the kernel at k = S with no predictor
    got = topk_attention(*map(_t, (q, k, v)), D ** -0.5, pixart_mx_specs(),
                         _port_cfg(**cfg), bias=_t(bias))[0]
    assert torch.equal(got, fused_topk_attention_ref(
        *map(_t, (q, k, v, bias)), k=40, approx=False, scale=D ** -0.5,
        flush=True, contract=contract))


def test_topk_entry_matches_jax():
    q, k, v, bias = split_inputs(40, seed=7, with_bias=True)
    cfg = dict(mx_quant=True, top_k=True, k=7, approx_flag=True,
               pred_mode="two_step_leading_ones")
    assert_split_matches_jax(
        lambda *a: topk_attention(*map(_t, a[:3]), D ** -0.5,
                                  pixart_mx_specs(), _port_cfg(**cfg),
                                  bias=_t(a[3]))[0],
        lambda *a: jax_topk(*map(_j, a[:3]), D ** -0.5,
                            finalize_mx_specs(PIXART), JaxAttnConfig(**cfg),
                            bias=_j(a[3]))[0], q, k, v, bias)


def test_dispatch_raises_where_jax_leaves_its_kernels():
    """Where JAX leaves its kernels for the XLA path the port takes its
    own XLA path (no kernel launches); the serving tier, a kernel tier,
    raises ValueError there as in JAX."""
    from mx_quantization_tpu_torch.attention import _xla_topk_dense
    q, k, v, _ = map(_t, split_inputs(40, seed=8, with_bias=False))
    specs = pixart_mx_specs()
    serving = _port_cfg(k=7, sparse_impl="gather", contract="serving")
    with pytest.raises(ValueError, match="serving"):
        topk_attention(q, k, v, 0.1, specs, serving)
    with pytest.raises(ValueError, match="serving"):
        topk_attention(q, k, v, 0.1, specs.replace(bfloat=0, fp=8),
                       serving._replace(sparse_impl="dense", top_k=False))
    out, idx = topk_attention(q, k, v, 0.1, specs,
                              serving._replace(contract="exact"))
    assert out.shape == q.shape and idx.shape == (*q.shape[:3], 7)
    # ELSA takes the kernels for square attention only (JAX's
    # elsa_kernel_ok): the reference takes the key norms at the query
    # index, and the XLA path's ELSA raises on non-square attention
    q64 = torch.cat([q, q[:, :, :24]], dim=2)
    with pytest.raises(ValueError, match="square"):
        topk_attention(q64, k, v, 0.1, specs, _port_cfg(pred_mode="ELSA"))
    with pytest.raises(ValueError, match="serving"):
        topk_attention(q64, k, v, 0.1, specs,
                       _port_cfg(pred_mode="ELSA", contract="serving"))
    # past the short path's limit the query-tiled kernel K4 takes over;
    # past the TPU kernels' key limit JAX leaves them for its XLA path
    long = torch.zeros(1, 1, MAX_SPLIT_TOKENS + 1, D)
    for cfg in (_port_cfg(), _port_cfg(top_k=False)):
        out, _ = topk_attention(long, long, long, 0.1, specs, cfg)
        assert out.shape == long.shape
    longer = torch.zeros(1, 1, MAX_TILED_KEYS + 1, D)
    few = long[:, :, :8]  # the key count decides; few queries keep it quick
    out, idx = topk_attention(few, longer, longer, 0.1, specs, _port_cfg())
    assert idx is None and torch.equal(out, _xla_topk_dense(
        few, longer, longer, 0.1, specs, _port_cfg()))
    out, _ = topk_attention(few, longer, longer, 0.1, specs,
                            _port_cfg(top_k=False))
    assert out.shape == few.shape and torch.isfinite(out).all()
    assert port_specs(PIXART) == specs
