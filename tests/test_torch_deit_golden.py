"""The port's DeiT against the reference torch DeiT's goldens
(tests/golden/deit_model.npz, written by tests/make_golden_deit.py from the
reference's own quantized modules and surgery at the DeiT operating point:
MXINT8, bfloat 32, k = 8, block 2 excluded), the second oracle beside the
JAX package.

The timm-name state dicts (deit_model_sd.pt: embed 64, 2 heads, depth 12;
deit_elsa_sd.pt: embed 128, depth 4) go through the port's
``load_deit_checkpoint``; the loaded module must equal the JAX loader's
tree carried over by ``vit_params_from_jax``, bit for bit.  The port's
forward (the "fused" engine, the only one ported) is held to each golden
output under JAX's own criterion (tests/test_deit_model_golden.py
``_check``), the same operating points and the same plans as JAX's test.
"""

import os

import numpy as np
import pytest
import torch

from mx_quantization_tpu.utils.checkpoint import \
    load_deit_checkpoint as jax_load_deit_checkpoint

from mx_quantization_tpu_torch.models.vit import (ViT, VitConfig,
                                                  VitQuantConfig, vit_forward)
from mx_quantization_tpu_torch.utils.checkpoint import (load_deit_checkpoint,
                                                        vit_params_from_jax)
from mx_quantization_tpu_torch.workloads.deit import default_mx_specs
from test_deit_model_golden import _check
from test_torch_dit512 import _one_torch_thread  # noqa: F401


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CFG = dict(img_size=32, patch_size=8, in_chans=3, num_classes=10,
           embed_dim=64, depth=12, num_heads=2)
ELSA_CFG = dict(CFG, embed_dim=128, depth=4)
FILES = {"deit_model_sd.pt": CFG, "deit_elsa_sd.pt": ELSA_CFG}


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "deit_model.npz"))


def _load(name):
    model = ViT(VitConfig(**FILES[name]), device="cpu")
    model.load_state_dict(load_deit_checkpoint(
        os.path.join(GOLDEN, name), depth=FILES[name]["depth"]))
    return model


@pytest.fixture(scope="module")
def model():
    return _load("deit_model_sd.pt")


@pytest.mark.parametrize("name", sorted(FILES))
def test_loader_matches_jax_loader(name):
    got = _load(name).state_dict()
    tree = jax_load_deit_checkpoint(os.path.join(GOLDEN, name),
                                    depth=FILES[name]["depth"])
    want = vit_params_from_jax(tree, VitConfig(**FILES[name]),
                               device="cpu").state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _qcfg(top_k=True, approx_flag=True, pred_mode="ex_pred",
          exclude_block_type="ex_pred"):
    """tests/test_deit_model_golden.py ``_qcfg``."""
    return VitQuantConfig(mx_specs=default_mx_specs(), mx_quant=True,
                          top_k=top_k, k=8, approx_flag=approx_flag,
                          pred_mode=pred_mode, exclude_blocks=(2,),
                          exclude_block_type=exclude_block_type)


PLANS = {
    "ex_pred": dict(pred_mode="ex_pred"),
    "two_step_leading_ones": dict(pred_mode="two_step_leading_ones"),
    "MXINT4": dict(pred_mode="MXINT4"),
    "partial_Q": dict(pred_mode="partial_Q"),
    "partial_K": dict(pred_mode="partial_K"),
    # excluded block 2 runs two_step while the rest run ex_pred
    "mixed_exclude": dict(exclude_block_type="two_step_leading_ones"),
    "true_topk": dict(approx_flag=False),
    "dense": dict(top_k=False, approx_flag=False),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_forward_matches_reference(golden, model, name):
    out = vit_forward(model, torch.from_numpy(golden["x"]),
                      _qcfg(**PLANS[name]))
    _check(out.numpy(), golden[f"out_{name}"])


def test_unquantized_forward_matches_reference(golden, model):
    out = vit_forward(model, torch.from_numpy(golden["x"]),
                      VitQuantConfig(mx_quant=False))
    np.testing.assert_allclose(out.numpy(), golden["out_fp"], rtol=2e-4,
                               atol=2e-4)


def test_elsa_matches_reference(golden):
    """ELSA at model level: head dim 64, depth 4, block 2 excluded (ex_pred
    fallback), the last-block rule off (the reference's block-11 rule never
    fires at depth 4), the golden's own projection matrix."""
    qcfg = VitQuantConfig(mx_specs=default_mx_specs(), mx_quant=True,
                          top_k=True, k=8, approx_flag=True,
                          pred_mode="ELSA", exclude_blocks=(2,),
                          exclude_block_type="ex_pred",
                          last_block_no_topk=False)
    out = vit_forward(_load("deit_elsa_sd.pt"),
                      torch.from_numpy(golden["x"]), qcfg,
                      torch.from_numpy(golden["elsa_matrix"]))
    _check(out.numpy(), golden["out_ELSA"])
