"""K3's and K4's predictor modes beyond ex_pred and two_step (MXINT4,
partial_Q, partial_K, true_ex, threshold_ex, ELSA) on the short path: the
port's plain version against the JAX package's ``fused_topk_attention`` in
interpret mode, each mode in both tiers, at N = S = 64 and at N = 64
queries against S = 40 keys with the caption-mask bias (ELSA, square only
in the reference, at N = S = 40 there).  The inputs and the criterion are
tests/test_torch_attention_split.py's (``assert_split_matches_jax``: every
query row within 2e-5, except at most 1% of rows, each with at most two
probabilities one grid step apart, read through a probe).  The modes are
spread over this file, ``test_torch_attention_modes_exp.py`` and
``test_torch_attention_modes_elsa.py``, so that the test run's workers
share them; this file also holds ELSA's projection to JAX's bit for bit.
"""

import numpy as np
import pytest
import torch

from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention as jax_kernel
from mx_quantization_tpu.predictors.elsa import \
    create_structured_orthogonal_matrix as jax_matrix

from mx_quantization_tpu_torch.ops.kernels.topk_attention import \
    fused_topk_attention_ref
from mx_quantization_tpu_torch.predictors.elsa import (
    THETA_BIAS, create_structured_orthogonal_matrix, orthogonal_matrix)
from test_torch_attention_split import (D, _j, _t, assert_split_matches_jax,
                                        split_inputs)

SHAPES = [(64, False), (40, True)]  # (S, with_bias)


def mode_inputs(mode, S, with_bias, seed):
    """split_inputs' q, k, v, bias; ELSA's q cut to S rows (square)."""
    q, k, v, bias = split_inputs(S, seed=seed, with_bias=with_bias)
    if mode == "ELSA":
        q = q[:, :, :S]
    return q, k, v, bias


def check_mode(mode, S, with_bias, contract, k=9, key_bits=32, inputs=None):
    """The plain version of ``mode`` against JAX's kernel, with ELSA's
    structured projection on both sides."""
    q, kk, v, bias = inputs or mode_inputs(mode, S, with_bias,
                                           seed=S + len(mode))
    proj = create_structured_orthogonal_matrix(D) if mode == "ELSA" else None
    kw = dict(k=k, scale=D ** -0.5, key_bits=key_bits, flush=True,
              contract=contract, pred_mode=mode)
    assert_split_matches_jax(
        lambda *a: fused_topk_attention_ref(*map(_t, a), _t(proj), **kw),
        lambda *a: jax_kernel(*map(_j, a), _j(proj), **kw), q, kk, v, bias,
        contract=contract)


@pytest.mark.parametrize("mode", ["MXINT4", "partial_Q"])
@pytest.mark.parametrize("S,with_bias", SHAPES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_plain_matches_jax_kernel(mode, S, with_bias, contract):
    check_mode(mode, S, with_bias, contract)


@pytest.mark.parametrize("dim", [64, 72])
def test_elsa_matrix_equals_jax(dim):
    ours = create_structured_orthogonal_matrix(dim)
    want = jax_matrix(dim)
    assert ours.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(ours, want)  # bit for bit
    np.testing.assert_array_equal(orthogonal_matrix(dim, "cpu").numpy(),
                                  want)
    # orthogonal up to f32 rounding
    np.testing.assert_allclose(ours @ ours.T, np.eye(dim), atol=1e-5)
    assert THETA_BIAS == 0.127
    with pytest.raises(ValueError, match="d=80"):
        create_structured_orthogonal_matrix(80)


def test_mxint4_block_exponent_is_the_int8_one():
    """MXINT4 re-quantizes the original side with its own int4 grid; on the
    int grids its block exponent equals the int8 one (both floor(log2 max)
    with emax 0), even where the int4 value rounds up to the grid's
    maximum 7 (the kernels derive both from the same block maximum)."""
    from mx_quantization_tpu_torch.formats import FormatParams
    from mx_quantization_tpu_torch.ops.fastquant import quantize_blocks
    x = torch.tensor([[[1.9, -0.01] + [0.0] * 30, [3.99] + [0.5] * 31]])
    v8, e8 = quantize_blocks(x, "int8", 8)
    v4, e4 = quantize_blocks(x, FormatParams(0, 4, 0, 0.0, 0.0), 8)
    assert torch.equal(e4, e8)
    assert v4[0, 0, 0] == 1.75 and v4[0, 1, 0] == 3.5  # clipped to 7 * 2^-2
    assert v4[0, 0, 1] == 0.0 and v8[0, 0, 1] != 0.0
