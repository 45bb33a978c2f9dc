"""The summation orders of K3's and K4's plain version
(``fused_topk_attention_ref``), which follow the kernels' int8 tensor-core
products: the true score sums each 32-element block exactly, scales it by
its two powers of two and adds the blocks in order; two_step's predictor is
an integer dot product (its operands are n / 64 for integers n), summed
exactly and rounded to float32 once.

The inputs scale q's middle 32-d block by 2^-12, so that its exponents lie
twelve binades below the other blocks', where the block order and the d
order round differently.  The true score is held to a float64 sum of each
block of the dequantized values, rounded to float32 at the block boundary;
the predictor to an int64 dot of the operands' numerators, cast once; each
is shown to differ from the d-order float32 sum.  The whole plain version
stays within the bound ``tests/test_torch_attention_split.py`` and
``tests/test_torch_attention_tiled.py`` hold it to against JAX's kernels in
interpret mode (rtol = atol = 2e-5, at most 1% of rows with a flipped
probability), on the short path and on the tiled path just over 512 keys.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention as jax_kernel

from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.ops.fastquant import quantize_blocks
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    _dot_in_order, _split_score_sums, _two_step_operand,
    fused_topk_attention_ref)
from test_torch_attention_split import assert_split_matches_jax
from test_torch_attention_tiled import assert_long_matches_jax

SCALES = (0, -12, 0)  # binades of q's three 32-d blocks (D = 72)
D = 72


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keeps this module's torch ops on one thread beside the other test
    processes (as tests/test_torch_attention_tiled.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spread(B, H, N, S, seed):
    """q (B, H, N, D) with its blocks scaled by 2^SCALES, k and v
    (B, H, S, D); q and k scaled by 2 as the split tests do."""
    rng = np.random.RandomState(seed)
    q = (2 * rng.randn(B, H, N, D)).astype(np.float32)
    for blk, sc in enumerate(SCALES):
        q[..., 32 * blk:32 * (blk + 1)] *= np.float32(2.0 ** sc)
    k = (2 * rng.randn(B, H, S, D)).astype(np.float32)
    v = rng.randn(B, H, S, D).astype(np.float32)
    return q, k, v


def _quantized_blocks(x, n_pad):
    """(..., n, D) float32 -> its MX values and exponents, blocks along D
    (..., n_pad, 3, 32), as the plain version forms them."""
    x = torch.nn.functional.pad(torch.from_numpy(x),
                                (0, 96 - D, 0, n_pad - x.shape[-2]))
    return quantize_blocks(x.reshape(*x.shape[:-1], 3, 32),
                           format_params("int8"), 8)


def test_true_score_sums_blocks_exactly_then_in_order():
    q, k, _ = _spread(1, 1, 64, 64, 0)
    st, _ = _split_score_sums(torch.from_numpy(q), torch.from_numpy(k),
                              format_params("int8"), 8, False, 0, None)
    qv, qe = _quantized_blocks(q[0, 0], 64)
    kv, _ = _quantized_blocks(k[0, 0], 64)
    assert (qe[:, 0] - qe[:, 1] >= 10).all()  # blocks 10+ binades apart
    qd, kd = qv.double().numpy(), kv.double().numpy()
    want = None
    for blk in range(3):  # each block exact in float64, rounded once
        term = (qd[:, blk] @ kd[:, blk].T).astype(np.float32)
        want = term if want is None else want + term
    np.testing.assert_array_equal(st[0, 0].numpy(), want)
    # the products added in d order (the first design's order) round
    # differently at these exponents
    old = _dot_in_order(qv.reshape(64, 96)[:, :D],
                        kv.reshape(64, 96)[:, :D].T)
    assert (old != st[0, 0]).float().mean() > 0.01


def test_two_step_predictor_is_one_exact_dot():
    """Here the first blocks of q and k are scaled by 2^40 as well: a
    two_step operand is e * (2^l1 + 2^l2) / 64 with e the block exponent,
    so its products reach 2^12 and the d-order float32 sums round."""
    q, k, _ = _spread(1, 1, 64, 64, 1)
    q[..., :32] *= np.float32(2.0 ** 40)
    k[..., :32] *= np.float32(2.0 ** 40)
    _, pred = _split_score_sums(torch.from_numpy(q), torch.from_numpy(k),
                                format_params("int8"), 8, False, 0,
                                "two_step_leading_ones")
    qv, qe = _quantized_blocks(q[0, 0], 64)
    kv, ke = _quantized_blocks(k[0, 0], 64)
    aq = _two_step_operand(qv, qe).reshape(64, 96)
    ak = _two_step_operand(kv, ke).reshape(64, 96)
    nq, nk = (aq * 64).numpy(), (ak * 64).numpy()
    assert (nq == np.round(nq)).all() and np.abs(nq).max() < 2 ** 14
    exact = nq.astype(np.int64) @ nk.astype(np.int64).T  # in 1/4096 units
    want = (exact.astype(np.float64) / 4096).astype(np.float32)
    np.testing.assert_array_equal(pred[0, 0].numpy(), want)
    old = _dot_in_order(aq[:, :D], ak[:, :D].T)  # the first design's order
    assert (old != pred[0, 0]).any()


@pytest.mark.parametrize("mode", ["two_step", "ex_pred"])
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_spread_blocks_match_jax_short_path(mode, contract):
    q, k, v = _spread(2, 2, 64, 64, 2)
    kw = dict(k=9, scale=D ** -0.5, key_bits=32, flush=True,
              contract=contract,
              pred_mode="two_step_leading_ones" if mode == "two_step"
              else "ex_pred")
    assert_split_matches_jax(
        lambda *a: fused_topk_attention_ref(
            *(None if t is None else torch.from_numpy(t) for t in a), **kw),
        lambda *a: jax_kernel(
            *(None if t is None else jnp.asarray(t) for t in a), **kw),
        q, k, v, None, contract=contract)


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_spread_blocks_match_jax_tiled_path(contract):
    """N = 64 queries against S = 544 keys: JAX's query-tiled path."""
    q, k, v = _spread(1, 2, 64, 544, 3)
    kw = dict(k=77, scale=D ** -0.5, key_bits=32, flush=True,
              contract=contract, pred_mode="two_step_leading_ones")
    assert_long_matches_jax(
        lambda *a: fused_topk_attention_ref(
            *(None if t is None else torch.from_numpy(t) for t in a), **kw),
        lambda *a: jax_kernel(
            *(None if t is None else jnp.asarray(t) for t in a), **kw),
        q, k, v, None, contract=contract)
