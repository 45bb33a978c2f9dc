"""The summation orders of K2's and K7's plain version
(``fused_topk_attention_qkv_ref``), which follow the kernel's int8
tensor-core products: each 32-element block of the true score and of the
exact tier's PV is summed exactly and scaled by its two powers of two, and
the blocks are added in order.

The inputs scale q's middle 32-d block by 2^-12, so that its exponents
lie twelve binades below the other blocks', where that order and the d
order round differently.  The block order is held to a float64 sum of
each block of the dequantized values, rounded to float32 at the block
boundary; the d order is shown to differ there; and the whole plain
version stays within the bound
``tests/test_torch_attention.py`` holds it to against JAX's kernel in
interpret mode (rtol = atol = 2e-5, at most 1% of rows with a flipped
probability).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention_qkv as jax_kernel

from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.ops.fastquant import quantize_blocks
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    _block_scaled_dot, _dot_in_order, _mx_mantissas,
    fused_topk_attention_qkv_ref)
from test_torch_attention import assert_matches_jax

SCALES = (0, -12, 0)  # binades of q's three 32-d blocks (D = 72)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keeps this module's torch ops on one thread beside the other test
    processes (as tests/test_torch_attention_tiled.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spread(B, N, H, D, seed):
    """(B, N, 3*H*D) float32 qkv with q's blocks scaled by 2^SCALES."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, 3, H, D).astype(np.float32)
    for blk, sc in enumerate(SCALES):
        x[:, :, 0, :, 32 * blk:32 * (blk + 1)] *= np.float32(2.0 ** sc)
    return x.reshape(B, N, 3 * H * D)


def _blocks(x, N, H, D):
    """q and k of the first batch row and head as (N, 3, 32) blocks, zero
    past D."""
    qk = torch.from_numpy(x[0]).reshape(N, 3, H, D)[:, :2, 0]
    qk = torch.nn.functional.pad(qk, (0, 96 - D))
    return qk[:, 0].reshape(N, 3, 32), qk[:, 1].reshape(N, 3, 32)


def test_true_score_sums_blocks_exactly_then_in_order():
    N, H, D = 64, 2, 72
    q, k = _blocks(_spread(1, N, H, D, 0), N, H, D)
    fmt = format_params("int8")
    qv, _ = quantize_blocks(q, fmt, 8)
    kv, _ = quantize_blocks(k, fmt, 8)
    qm, qe = _mx_mantissas(q, fmt, 8, False)
    km, ke = _mx_mantissas(k, fmt, 8, False)
    assert (qe[:, 0] - qe[:, 1] >= 10).all()  # blocks 10+ binades apart
    got = _block_scaled_dot(qm, qe, km, ke, fmt[1] - 2)

    # float64 sum of each block of the dequantized values (exact), rounded
    # to float32 at the block boundary, the blocks added in float32
    qd, kd = qv.double().numpy(), kv.double().numpy()
    want = None
    for blk in range(3):
        term = (qd[:, blk] @ kd[:, blk].T).astype(np.float32)
        want = term if want is None else want + term
    np.testing.assert_array_equal(got.numpy(), want)

    # the products added in d order (the first design's order) round
    # differently at these exponents
    old = _dot_in_order(qv.reshape(N, 96)[:, :D],
                        kv.reshape(N, 96)[:, :D].T)
    assert (old != got).float().mean() > 0.01


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_spread_blocks_match_jax(contract):
    B, N, H, D = 2, 64, 2, 72
    x = _spread(B, N, H, D, 1)
    kw = dict(k=9, scale=D ** -0.5, key_bits=8, bfloat=16,
              contract=contract)
    assert_matches_jax(
        lambda a: fused_topk_attention_qkv_ref(torch.from_numpy(a), H,
                                               **kw),
        lambda a: jax_kernel(jnp.asarray(a), H, **kw), x, H,
        contract=contract)
