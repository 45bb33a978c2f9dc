"""K3's and K4's threshold_ex and ELSA predictors on the short path, the
plain version against JAX's interpret-mode kernel in both tiers
(tests/test_torch_attention_modes.py's shapes and criterion), and ELSA's
parts on their own:
  * the hash bits of quantized rows against JAX's ``_prep_side``: a bit may
    differ only where |proj . v| lies within the float32 rounding bound of
    a D-term sum, gamma_D * sum |proj_d v_d| (the two sum in other orders);
    such bits are counted and printed;
  * tie-heavy rows: keys in groups of identical copies, so that most query
    rows meet several keys at the k-th hamming distance; each tier's tie
    rule (the exact tier's lowest index first, the serving tier's every
    tie) must select JAX's keys.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.ops.kernels.topk_attention import _prep_side

from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.ops.fastquant import quantize_blocks
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    _bf16, _elsa_hash, _split_blocks, _split_score_sums)
from mx_quantization_tpu_torch.predictors.elsa import \
    create_structured_orthogonal_matrix
from test_torch_attention_modes import SHAPES, check_mode
from test_torch_attention_split import D, split_inputs


@pytest.mark.parametrize("mode", ["threshold_ex", "ELSA"])
@pytest.mark.parametrize("S,with_bias", SHAPES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_plain_matches_jax_kernel(mode, S, with_bias, contract):
    check_mode(mode, S, with_bias, contract)


def test_elsa_hash_bits_match_jax():
    q, _, _, _ = split_inputs(64, seed=17, with_bias=False, n=256)
    proj = create_structured_orthogonal_matrix(D)
    Dp = 96
    pmat = np.pad(proj, ((0, 0), (0, Dp - D)))
    qb = _split_blocks(torch.from_numpy(q), 256, Dp, 0)
    vals, _ = quantize_blocks(qb, format_params("int8"), 8, True)
    vals = _bf16(vals)
    ours = _elsa_hash(vals, torch.from_numpy(proj)).numpy()  # (B, H, N, bits)
    v = vals.reshape(*vals.shape[:-2], Dp).numpy()
    gamma = D * 2.0 ** -24 / (1 - D * 2.0 ** -24)
    differ = near = 0
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            _, want = _prep_side(jnp.asarray(q[b, h]), 32, 8, 8, D, True,
                                 "ELSA", side="q", proj=jnp.asarray(pmat),
                                 flush=True)
            want = np.asarray(want, np.float32).T  # (N, bits)
            diff = ours[b, h] != want
            terms = np.abs(v[b, h][:, None, :] * pmat[None])  # (N, bits, Dp)
            exact = (v[b, h].astype(np.float64) @ pmat.T.astype(np.float64))
            bound = gamma * terms.sum(-1)
            differ += int(diff.sum())
            near += int((np.abs(exact) <= bound).sum())
            assert (np.abs(exact)[diff] <= bound[diff]).all()
    print(f"ELSA hash: {differ} of {ours.size} bits differ from JAX's, "
          f"{near} lie within the rounding bound")
    assert differ <= near


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_elsa_tie_rule_matches_jax(contract):
    q, k, v, _ = split_inputs(64, seed=23, with_bias=False)
    k = np.repeat(k[:, :, ::8], 8, axis=2)  # 8 copies of each key
    # the k-th predictor score of most rows is shared by several keys
    proj = torch.from_numpy(create_structured_orthogonal_matrix(D))
    fmt = format_params("int8")
    _, sel = _split_score_sums(torch.from_numpy(q), torch.from_numpy(k), fmt,
                               8, True, 0, "ELSA", proj)
    kth = torch.sort(sel, dim=-1, descending=True).values[..., 8:9]
    ties = (sel == kth).sum(-1)
    assert (ties >= 2).float().mean() > 0.9
    check_mode("ELSA", 64, False, contract, inputs=(q, k, v, None))
