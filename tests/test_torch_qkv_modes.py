"""K2's and K7's plain versions in every predictor of the TPU kernels' qkv
entries beyond ex_pred (two_step_leading_ones, MXINT4, partial_Q,
partial_K, true_ex, threshold_ex; ex_pred is tests/test_torch_attention.py's
and tests/test_torch_qkv_split_t.py's) against the JAX package's
``fused_topk_attention_qkv`` and ``fused_topk_attention_qkv_t`` in
interpret mode, each mode in both tiers, and one padded case past 256
tokens for each (K2: N = 300, K7: N = 384); and the port's gates
(``fused_qkv_eligible``, ``split_t_eligible``) against JAX's.

K2's cases: f32 qkv, bfloat 0, key_bits 32 with flush (DeiT's kind of
call), N = 64 queries of D = 72 in 2 heads; K7's: bfloat 16, key_bits 8
(DiT's), N = 128 of D = 72.  The criterion is tests/test_torch_attention.py's
``check_rows``: every query row within 2e-5, except at most 1% of rows,
each with at most two probabilities one grid step apart, the probabilities
read through probes that set v to the identity over D keys at a time.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu import finalize_mx_specs
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import \
    fused_qkv_eligible as jax_fused_qkv_eligible
from mx_quantization_tpu.ops.fastquant import \
    fused_eligible as jax_fused_eligible
from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention_qkv as jax_k2
from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention_qkv_t as jax_k7

from mx_quantization_tpu_torch.attention import (TopKAttentionConfig,
                                                 fused_qkv_eligible,
                                                 split_t_eligible)
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    QKV_PRED_MODES, fused_topk_attention_qkv_ref,
    fused_topk_attention_qkv_t_ref)
from mx_quantization_tpu_torch.specs import finalize_mx_specs as port_specs
from test_torch_attention import SPECS, TOL, check_rows
from test_torch_dit512 import _one_torch_thread  # noqa: F401
from test_torch_qkv_split_t import assert_k7_matches_jax, split_t_operands

MODES = QKV_PRED_MODES[1:]


def assert_k2_matches_jax(port, jax_fn, x, H, contract):
    """port, jax_fn: (B, N, 3*H*D) float32 array -> (B, N, H*D); the
    criterion of the module docstring, v probed D keys at a time."""
    B, N, F = x.shape
    D = F // (3 * H)

    def cells(a):  # (B, N, H*D) -> (B*H, N, D)
        return np.asarray(a, np.float32).reshape(B, N, H, D).transpose(
            0, 2, 1, 3).reshape(B * H, N, D)

    got, want = cells(port(x)), cells(jax_fn(x))
    if np.isclose(got, want, **TOL).all():
        return
    pg, pw = [], []
    for c0 in range(0, N, D):
        keys = np.arange(c0, min(c0 + D, N))
        probe = x.copy().reshape(B, N, 3, H, D)
        probe[:, :, 2] = 0.0
        probe[:, keys, 2, :, keys - c0] = 1.0
        probe = probe.reshape(B, N, F)
        pg.append(cells(port(probe))[..., :len(keys)])
        pw.append(cells(jax_fn(probe))[..., :len(keys)])
    vmax = np.abs(x.reshape(B, N, 3, H, D)[:, :, 2]).max(axis=(1, 3))
    check_rows(got, want, np.concatenate(pg, -1), np.concatenate(pw, -1),
               vmax.reshape(B * H), contract=contract)


def check_k2(mode, contract, N, seed):
    H, D = 2, 72
    x = np.random.RandomState(seed).randn(2, N, 3 * H * D).astype(np.float32)
    kw = dict(k=N // 5, scale=D ** -0.5, key_bits=32, flush=True,
              pred_mode=mode, contract=contract)
    assert_k2_matches_jax(
        lambda a: fused_topk_attention_qkv_ref(torch.from_numpy(a), H, **kw),
        lambda a: jax_k2(jnp.asarray(a), H, **kw), x, H, contract)


def check_k7(mode, contract, N, seed):
    H, D = 2, 72
    qkv = np.random.RandomState(seed).randn(2, N, 3 * H * D).astype(
        np.float32)
    qk_t, v = split_t_operands(qkv, H, 96)
    kw = dict(k=N // 6, scale=D ** -0.5, n_valid=N, key_bits=8, bfloat=16,
              pred_mode=mode, contract=contract)
    assert_k7_matches_jax(
        lambda a, b: fused_topk_attention_qkv_t_ref(
            torch.from_numpy(a), torch.from_numpy(b), H, **kw),
        lambda a, b: jax_k7(jnp.asarray(a), jnp.asarray(b), H, **kw),
        qk_t, v, H, contract)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_k2_plain_matches_jax_kernel(mode, contract):
    check_k2(mode, contract, 64, seed=len(mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_k7_plain_matches_jax_kernel(mode, contract):
    check_k7(mode, contract, 128, seed=2 * len(mode))


def test_k2_plain_past_256_tokens_matches_jax():
    """N = 300: padded to 320 keys (the kernel's 32) and 384 (JAX's 128)."""
    check_k2("two_step_leading_ones", "serving", 300, seed=11)


def test_k7_plain_past_256_tokens_matches_jax():
    check_k7("MXINT4", "exact", 384, seed=12)


@pytest.mark.parametrize("mode", QKV_PRED_MODES + ("ELSA",))
def test_gates_equal_jax(mode):
    """The port's qkv gate and DiT's split-emission gate return JAX's for
    each mode, N in {256, 257, 384, 512, 513}, with and without the
    predictor, at DiT's specs (bfloat 16) and DeiT's (bfloat 32)."""
    for bfloat in (16, 32):
        specs = dict(SPECS, bfloat=bfloat)
        jspecs, pspecs = finalize_mx_specs(specs), port_specs(specs)
        for approx in (True, False):
            cfg = dict(mx_quant=True, top_k=True, k=20, approx_flag=approx,
                       pred_mode=mode, key_bits=8)
            jcfg, pcfg = JaxAttnConfig(**cfg), TopKAttentionConfig(**cfg)
            for n in (256, 257, 384, 512, 513):
                want = jax_fused_qkv_eligible(jspecs, jcfg, n)
                assert fused_qkv_eligible(pspecs, pcfg, n) == want
                want_t = (n % 128 == 0 and want and jax_fused_eligible(
                    jspecs, jspecs.a_elem_format, jspecs.w_elem_format))
                assert split_t_eligible(pspecs, pcfg, n) == want_t
                assert want == (n <= 512 and (mode != "ELSA" or not approx))
