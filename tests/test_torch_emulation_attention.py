"""The XLA attention path of the port (``attention.py`` outside the kernels,
``ops/selection.py``, ``predictors/{exponent,elsa}.py``) against the JAX
package, and against the reference-torch attention goldens.

* Selection: ``kth_largest``, ``_topk_mask`` and the top-k indices equal
  JAX's (``jax.lax.top_k``'s order: descending in XLA's total order, ties
  lowest index first), with tie-heavy power-of-two scores
  (tests/test_fastpath.py:103-118) and signed zeros.
* Predictors: every ``exponent_predict`` mode on both engines bit for bit;
  ``ElsaApproximation``'s hashes bit for bit and its scores to cos's ulps.
* ``topk_attention``'s XLA branches at the golden shape (2 x 3 heads, 64
  tokens, D = 64; JAX's eager dispatch compiles per shape, so every JAX
  call here shares it): the ref engine's dense top-k (scatter), dense
  no-top-k and "gather"; the fused engine's masked-softmax fallback (a
  per-head bias, which no kernel takes) and "gather".  The selected
  indices equal JAX's; the outputs are held to
  tests/test_attention_golden.py's 2e-4 / 2e-5 on at least 99% of the
  query rows (an exp ulp can move one MX grid point of a row's
  probabilities).
* The mirror of tests/test_attention_golden.py on the port's ref engine,
  every mode with its acceptance rule unchanged.
* contract="serving" off the kernels raises ValueError, as in JAX.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.attention as jax_attention
from mx_quantization_tpu.ops.selection import kth_largest as jax_kth
from mx_quantization_tpu.predictors.elsa import \
    ElsaApproximation as JaxElsa
from mx_quantization_tpu.predictors.exponent import \
    exponent_predict as jax_exponent_predict
from mx_quantization_tpu.specs import finalize_mx_specs as jax_finalize

import mx_quantization_tpu_torch.attention as port_attention
from mx_quantization_tpu_torch.attention import (TopKAttentionConfig,
                                                 _topk_mask, topk_attention)
from mx_quantization_tpu_torch.ops.selection import kth_largest, \
    top_k_indices
from mx_quantization_tpu_torch.predictors.elsa import ElsaApproximation
from mx_quantization_tpu_torch.predictors.exponent import exponent_predict
from mx_quantization_tpu_torch.specs import finalize_mx_specs
from test_torch_emulation_quant import (_one_torch_thread,  # noqa: F401
                                        assert_bits_equal)

Z = np.load(os.path.join(os.path.dirname(__file__), "golden",
                         "attention.npz"))
SPEC = dict(w_elem_format="int8", a_elem_format="int8", scale_bits=8,
            block_size=32, bfloat=0, round="nearest", quantize_backprop=False)
SPECS = finalize_mx_specs(dict(SPEC))
FUSED = SPECS.replace(custom_tpu="fused")
Q, K, V = (torch.from_numpy(Z[n]) for n in ("q", "k", "v"))
KK = int(Z["kk"])
SCALE = Q.shape[-1] ** -0.5
PRED_MODES = ("ex_pred", "partial_Q", "partial_K", "two_step_leading_ones",
              "MXINT4", "true_ex", "threshold_ex")


def _j(t):
    return jnp.asarray(t.numpy())


def _jax_specs(specs):
    return jax_finalize(specs.to_dict())


def assert_rows_close(got, want, share=0.99):
    """tests/test_attention_golden.py's output bound on ``share`` of the
    query rows (the last axis is a row's output)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5).all(-1)
    assert close.mean() >= share, f"{1 - close.mean():.4f} of rows differ"


def test_selection_matches_jax_with_ties():
    rng = np.random.RandomState(12)
    s = (2.0 ** rng.randint(-3, 3, (4, 16, 40)) *
         np.sign(rng.randn(4, 16, 40))).astype(np.float32)
    s[0, 0, :6] = [0.0, -0.0, 0.0, -0.0, 0.0, -0.0]
    s[0, 1, :] = -0.0
    for k in (1, 7, 40):
        assert_bits_equal(kth_largest(torch.from_numpy(s), k),
                          jax_kth(jnp.asarray(s), k))
        mask = _topk_mask(torch.from_numpy(s), k).numpy()
        np.testing.assert_array_equal(
            mask, np.asarray(jax_attention._topk_mask(jnp.asarray(s), k)))
        _, jidx = jax.lax.top_k(jnp.asarray(s), k)
        idx = top_k_indices(torch.from_numpy(s), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert (mask.sum(-1) == k).all()
        ref = np.zeros(s.shape, bool)
        np.put_along_axis(ref, idx.numpy(), True, axis=-1)
        np.testing.assert_array_equal(mask, ref)


@pytest.mark.parametrize("mode", PRED_MODES)
def test_exponent_predict_matches_jax(mode):
    for specs in (SPECS, FUSED, FUSED.replace(bfloat=16)):
        aq, ak = exponent_predict(Q, K, specs, mode)
        jq, jk = jax_exponent_predict(_j(Q), _j(K), _jax_specs(specs), mode)
        assert_bits_equal(aq, jq, f"{mode} {specs.custom_tpu}")
        assert_bits_equal(ak, jk, f"{mode} {specs.custom_tpu}")
    with pytest.raises(ValueError):
        exponent_predict(Q, K, SPECS, "sanger")


def test_elsa_matches_jax_and_is_square_only():
    got = ElsaApproximation(Q, K, SPECS)
    want = JaxElsa(_j(Q), _j(K), _jax_specs(SPECS))
    assert_bits_equal(got.projection_matrix, want.projection_matrix)
    for x, jx in ((got.MX_Q, want.MX_Q), (got.MX_K, want.MX_K)):
        assert_bits_equal(x, jx)
        np.testing.assert_array_equal(
            got.compute_hashes(x).numpy(),
            np.asarray(want.compute_hashes(jx)))
    np.testing.assert_allclose(got.approximation_scores().numpy(),
                               np.asarray(want.approximation_scores()),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="square"):
        ElsaApproximation(Q, K[:, :, :40], SPECS).approximation_scores()


def _both(specs, bias=None, om=None, **cfg):
    """(port (out, idx), JAX (out, idx)) of topk_attention."""
    port = topk_attention(Q, K, V, SCALE, specs, TopKAttentionConfig(**cfg),
                          orthogonal_matrix=om, bias=bias)
    jax_out = jax_attention.topk_attention(
        _j(Q), _j(K), _j(V), SCALE, _jax_specs(specs),
        jax_attention.TopKAttentionConfig(**cfg),
        orthogonal_matrix=None if om is None else _j(om),
        bias=None if bias is None else _j(bias))
    return port, jax_out


@pytest.mark.parametrize("mode", PRED_MODES + ("ELSA", "true_topk"))
def test_ref_engine_branches_match_jax(mode):
    """The ref engine: dense top-k (scatter) and "gather", idx equal."""
    cfg = dict(k=KK, pred_mode=mode, approx_flag=mode != "true_topk")
    for impl in ("dense", "gather"):
        (out, idx), (jout, jidx) = _both(SPECS, sparse_impl=impl, **cfg)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert_rows_close(out, jout)


def test_ref_dense_no_topk_and_serving_raise():
    (out, idx), (jout, jidx) = _both(SPECS, top_k=False)
    assert idx is None and jidx is None
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-4,
                               atol=2e-5)
    for cfg in (dict(top_k=False), dict(k=KK), dict(k=KK,
                                                    sparse_impl="gather")):
        with pytest.raises(ValueError, match="serving"):
            topk_attention(Q, K, V, SCALE, SPECS,
                           TopKAttentionConfig(contract="serving", **cfg))


@pytest.mark.parametrize("mode", ["ex_pred", "two_step_leading_ones"])
def test_fused_fallbacks_match_jax(mode):
    """The fused engine off its kernels: a per-head bias (the kernels take
    a (B, 1, 1, S) key mask only) takes the masked-softmax fallback, dense
    top-k and no-top-k; "gather" takes the gathered product."""
    rng = np.random.RandomState(3)
    bias = torch.from_numpy(
        (rng.rand(2, 3, 64, 64) < 0.1).astype(np.float32) * -10000.0)
    for cfg, b in ((dict(k=KK, pred_mode=mode), bias),
                   (dict(top_k=False), bias),
                   (dict(k=KK, pred_mode=mode, sparse_impl="gather"), None)):
        (out, idx), (jout, jidx) = _both(FUSED, bias=b, **cfg)
        if jidx is None:
            assert idx is None
        else:
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert_rows_close(out, jout)
    # the fallback is JAX's differentiation surrogate of the kernel
    acfg = dict(k=KK, pred_mode=mode)
    got = port_attention._xla_topk_dense(
        Q, K, V, SCALE, FUSED, TopKAttentionConfig(**acfg), bias)
    want = jax_attention._xla_topk_dense(
        _j(Q), _j(K), _j(V), SCALE, _jax_specs(FUSED),
        jax_attention.TopKAttentionConfig(**acfg), _j(bias))
    assert_rows_close(got, want)


GOLDEN_MODES = {
    # golden key -> (top_k, approx_flag, pred_mode)
    "dense": (False, True, "ex_pred"),
    "true_topk": (True, False, "ex_pred"),
    "ex_pred": (True, True, "ex_pred"),
    "true_ex": (True, True, "true_ex"),
    "two_step_leading_ones": (True, True, "two_step_leading_ones"),
    "MXINT4": (True, True, "MXINT4"),
    "partial_Q": (True, True, "partial_Q"),
    "partial_K": (True, True, "partial_K"),
}


@pytest.mark.parametrize("mode", sorted(GOLDEN_MODES))
def test_attention_matches_reference_golden(mode):
    """tests/test_attention_golden.py on the port's ref engine, its
    acceptance rule unchanged."""
    top_k, approx, pred_mode = GOLDEN_MODES[mode]
    cfg = TopKAttentionConfig(mx_quant=True, top_k=top_k, k=KK,
                              approx_flag=approx, pred_mode=pred_mode,
                              sparse_impl="dense")
    out, _ = topk_attention(Q, K, V, SCALE, SPECS, cfg)
    want = Z[f"out_{mode}"]
    got = out.numpy()
    if mode == "dense":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        return
    ref_idx = Z[f"idx_{mode}"]
    ref_pred = Z[f"pred_{mode}"]
    _, our_idx = topk_attention(Q, K, V, SCALE, SPECS,
                                cfg._replace(sparse_impl="gather"))
    our_idx = our_idx.numpy()
    ours_vals = np.sort(np.take_along_axis(ref_pred, our_idx, axis=-1), -1)
    ref_vals = np.sort(np.take_along_axis(ref_pred, ref_idx, axis=-1), -1)
    np.testing.assert_allclose(ours_vals, ref_vals, rtol=1e-5, atol=1e-6,
                               err_msg=f"{mode}: selected multisets differ")
    same_rows = (np.sort(our_idx, -1) == np.sort(ref_idx, -1)).all(-1)
    assert same_rows.mean() > 0.3, (
        f"{mode}: suspiciously few identical selections "
        f"({same_rows.mean():.3f})")
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5).all(-1)
    agree = close[same_rows]
    assert agree.mean() > 0.99, (
        f"{mode}: outputs differ on {1 - agree.mean():.4f} of rows with "
        "identical selections")
