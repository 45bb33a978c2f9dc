"""K3's and K4's other predictor modes (MXINT4, partial_Q, partial_K,
true_ex, threshold_ex, ELSA) on the query-tiled long-sequence path: the
plain version against JAX's tiled kernel in interpret mode, each mode in
one tier (both tiers are held on the short path,
tests/test_torch_attention_modes*.py), at tests/test_torch_attention_tiled.py's
shapes and criterion.  ELSA's case is square (N = S = 640, three query
tiles of 256 in JAX) at key_bits 8, where the norm that scales a row's
scores moves which cosines share a key, and with the keys at indices 300
and 600 zero, so that those query rows (in JAX's second and third tiles)
score every key 0 and select by index: the norm must be taken at the
query's global index, as JAX's tiled kernel takes it at the tile's offset.
"""

import pytest
import torch

from mx_quantization_tpu_torch.ops.kernels.topk_attention import \
    _split_score_sums
from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.predictors.elsa import \
    create_structured_orthogonal_matrix
from test_torch_attention_tiled import (D, _one_torch_thread,  # noqa: F401
                                        _port_and_jax,
                                        assert_long_matches_jax, long_inputs)

CASES = [("MXINT4", "640x640", "exact"),
         ("partial_Q", "640x120_bias", "serving"),
         ("partial_K", "200x640", "exact"),
         ("true_ex", "640x640", "serving"),
         ("threshold_ex", "640x120_bias", "exact")]


@pytest.mark.parametrize("mode,shape,contract", CASES)
def test_plain_matches_jax_tiled_kernel(mode, shape, contract):
    q, kk, v, bias = long_inputs(shape, seed=len(mode) + len(shape))
    kw = dict(k=77, scale=D ** -0.5, flush=True, key_bits=32,
              contract=contract, pred_mode=mode)
    assert_long_matches_jax(*_port_and_jax(**kw), q, kk, v, bias,
                            contract=contract)


def test_elsa_norm_at_the_query_index_matches_jax_tiled_kernel():
    q, kk, v, _ = long_inputs("640x640", seed=29)
    kk[:, :, [300, 600]] = 0.0
    proj = create_structured_orthogonal_matrix(D)
    _, sel = _split_score_sums(torch.from_numpy(q), torch.from_numpy(kk),
                               format_params("int8"), 8, True, 0, "ELSA",
                               torch.from_numpy(proj))
    zero = (sel == 0).all(-1)  # (B, H, N): the rows whose key norm is 0
    assert zero[..., [300, 600]].all() and zero.sum() == 2 * zero.shape[1]
    kw = dict(k=77, scale=D ** -0.5, flush=True, key_bits=8,
              contract="exact", pred_mode="ELSA")
    port, jax_fn = _port_and_jax(**kw)
    assert_long_matches_jax(lambda *a: port(*a[:4], proj),
                            lambda *a: jax_fn(*a[:4], proj), q, kk, v, None)
