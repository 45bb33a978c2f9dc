"""The three CLIs of the port against the JAX package's parsers, and each
run on the emulation engine (``--engine ref``) with ``--device cpu`` at a
tiny size.

Every option of JAX's ``build_argparser`` is in the port's with the same
default, choices, nargs and type; the port adds only ``--device`` (the
card or the CPU) and, on the DiT and PixArt CLIs, ``--key-bits``,
``--activation-dtype`` and ``--prequantize`` (the serving operating
points).  The options the port does not serve yet (DeiT's and DiT's
``--anal``) are parsed and raise, naming ROADMAP.md.
"""

import numpy as np
import pytest

import mx_quantization_tpu.workloads.deit as jax_deit
import mx_quantization_tpu.workloads.dit as jax_dit
import mx_quantization_tpu.workloads.pixart as jax_pixart

from mx_quantization_tpu_torch.models.vit import VIT_CONFIGS, VitConfig
from mx_quantization_tpu_torch.ops.kernels.quantize import mx_quantize
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    fused_topk_attention, fused_topk_attention_qkv)
from mx_quantization_tpu_torch.workloads import deit, dit, pixart
from test_torch_emulation_quant import _one_torch_thread  # noqa: F401

PORT_ONLY = {"deit": {"--device"},
             "dit": {"--device", "--key-bits", "--activation-dtype",
                     "--prequantize"},
             "pixart": {"--device", "--key-bits", "--activation-dtype",
                        "--prequantize"}}
CLIS = {"deit": (jax_deit, deit), "dit": (jax_dit, dit),
        "pixart": (jax_pixart, pixart)}


def _options(parser):
    return {a.option_strings[-1]: (a.default, a.choices, a.nargs, a.type,
                                   a.const)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_options_match_jax(cli):
    jax_mod, port_mod = CLIS[cli]
    want = _options(jax_mod.build_argparser())
    got = _options(port_mod.build_argparser())
    assert set(got) - set(want) == PORT_ONLY[cli]
    assert set(want) <= set(got)
    for opt, spec in want.items():
        assert got[opt] == spec, opt


def _launches():
    return [k.launches for k in (mx_quantize, fused_topk_attention,
                                 fused_topk_attention_qkv)]


def test_clis_run_the_ref_engine_on_the_cpu(monkeypatch, tmp_path, capsys):
    before = _launches()
    monkeypatch.setitem(VIT_CONFIGS, "deit_tiny_patch16_224", VitConfig(
        img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
        num_heads=2))
    stats = deit.main(["--device", "cpu", "--batch-size", "2", "--mx-quant",
                       "--top-k", "--k", "6", "--engine", "ref",
                       "--sparse-impl", "gather"])
    assert stats["n"] == 2
    out = tmp_path / "dit.npz"
    dit.main(["--device", "cpu", "--model", "DiT-debug", "--image-size",
              "64", "--num-classes", "10", "--classes", "1", "3",
              "--num-steps", "2", "--mx-quant", "--top-k", "--k", "6",
              "--exclude-blocks", "1", "--engine", "ref", "--out", str(out)])
    lat = np.load(out)["latents"]
    assert lat.shape == (2, 4, 8, 8) and np.isfinite(lat).all()
    out = tmp_path / "pixart.npz"
    pixart.main(["--device", "cpu", "--num-layers", "2", "--num-heads", "2",
                 "--head-dim", "16", "--caption-channels", "32",
                 "--image-size", "64", "--max-token-length", "8",
                 "--num-steps", "2", "--mx-quant", "--self-top-k",
                 "--self-k", "6", "--cross-top-k", "--cross-k", "5",
                 "--engine", "ref", "--prompts", "a", "--out", str(out)])
    lat = np.load(out)["latents"]
    assert lat.shape == (1, 4, 8, 8) and np.isfinite(lat).all()
    assert _launches() == before  # the ref engine runs no kernel
    capsys.readouterr()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dit.main(["--device", "cpu", "--anal"])
