"""Hygiene of the PyTorch port: it stands alone (no JAX, nothing of the JAX
package), its entry points default to the GPU and raise where there is none,
and ``chip_smoke.py`` fails without a card or without the package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mx_quantization_tpu_torch as port
from mx_quantization_tpu_torch.models.dit import DiT, DiTConfig, init_dit
from mx_quantization_tpu_torch.models.pixart import (PixArt, PixArtConfig,
                                                     PixArtQuantConfig,
                                                     init_pixart)
from mx_quantization_tpu_torch.ops.linear import linear
from mx_quantization_tpu_torch.specs import finalize_mx_specs
from mx_quantization_tpu_torch.workloads import dit as dit_workload
from mx_quantization_tpu_torch.workloads import pixart as pixart_workload

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = Path(port.__file__).parent
TINY = DiTConfig(input_size=4, hidden_size=64, depth=1, num_heads=2,
                 num_classes=4)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "mx_quantization_tpu"
            or name.startswith("mx_quantization_tpu."))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")


def test_import_loads_no_jax():
    mods = sorted(p.relative_to(ROOT).with_suffix("").as_posix()
                  .replace("/", ".")
                  for p in PORT_DIR.rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mx_quantization_tpu' or "
            "m.startswith('mx_quantization_tpu.')]\n"
            "assert not bad, bad\nprint(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT_DIR.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiT(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_dit(TINY, torch.Generator())
    model = init_dit(TINY, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dit_workload.sample_dit(model, dit_workload.DiTQuantConfig(), [0],
                                torch.Generator(), num_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dit_workload.main(["--model", "DiT-debug", "--image-size", "32"])


def test_pixart_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = PixArtConfig(num_attention_heads=2, attention_head_dim=72,
                       num_layers=1, sample_size=4, caption_channels=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PixArt(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_pixart(cfg, torch.Generator())
    model = init_pixart(cfg, torch.Generator(), device="cpu")
    embeds, mask = torch.zeros(1, 8, 32), torch.ones(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pixart_workload.sample_pixart(model, PixArtQuantConfig(), embeds,
                                      mask, embeds, torch.Generator(),
                                      num_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pixart_workload.main(["--num-layers", "1", "--image-size", "32"])


def test_only_the_fused_engine_is_ported():
    """Both of JAX's engines are ported: the default "ref" (the emulation
    engine) and "fused"; another engine name raises."""
    specs = finalize_mx_specs(dict(w_elem_format="int8",
                                   a_elem_format="int8", block_size=32))
    assert specs.custom_tpu == "ref"
    x, w = torch.ones(2, 32), torch.ones(4, 32)
    want = torch.full((2, 4), 32.0)
    assert torch.equal(linear(x, w, mx_specs=specs), want)
    assert torch.equal(
        linear(x, w, mx_specs=specs.replace(custom_tpu="fused")), want)
    with pytest.raises(ValueError, match="engine"):
        specs.replace(custom_tpu="triton")


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path, no_cuda):
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ, "PYTHONPATH": ""})
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
