"""The port's attention-ablation tools (``mx_quantization_tpu_torch/tools/``
``attnk_bench.py``, ``attnk3_bench.py``, ``servingk_bench.py``,
``passprice_bench.py``) against their TPU counterparts in ``tools/``: each
table covers every mode string its counterpart runs (read from the TPU
tool's source: its mode lists, its ``MODES`` default, its ``LADDER``, and
the variants its other ``make*`` and probe functions time), mode strings
that share one K8 call are equal in JAX too, each tool's command line runs
on the CPU, and the new modules import no JAX."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_ablate import _bf16_jnp, _inputs, jax_mode, tpu  # noqa: F401

from mx_quantization_tpu_torch.tools import (ablate_common, attnk3_bench,
                                             attnk_bench, passprice_bench,
                                             servingk_bench)

ROOT = Path(__file__).resolve().parents[1]


def _tree(name):
    return ast.parse((ROOT / "tools" / f"{name}.py").read_text())


def _for_lists(tree):
    """The string lists that the tool's ``for mode in [...]`` loops run."""
    return [[e.value for e in node.iter.elts] for node in ast.walk(tree)
            if isinstance(node, ast.For) and isinstance(node.iter, ast.List)
            and all(isinstance(e, ast.Constant) for e in node.iter.elts)]


def _modes_default(tree):
    """The default of ``os.environ.get("MODES", "...")``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and len(node.args) == 2 and \
                isinstance(node.args[0], ast.Constant) and \
                node.args[0].value == "MODES":
            return node.args[1].value.split(",")
    raise AssertionError("no MODES default")


def test_attnk_table_covers_the_tpu_tool():
    base, trans = _for_lists(_tree("attnk_bench"))
    want = set(base) | {"i16", "batched"} | {f"trans-{m}" for m in trans}
    assert set(attnk_bench.TABLE) == want
    assert {v.site for v in attnk_bench.TABLE.values()} == {
        f"tools/attnk_bench.py:{n}" for n in (119, 258, 341, 464)}


def test_attnk3_table_covers_the_tpu_tool():
    default = _modes_default(_tree("attnk3_bench"))
    assert tuple(default) == attnk3_bench.DEFAULT_MODES
    assert set(attnk3_bench.TABLE) == set(default) | {
        "v1", "v3", "nocount", "norank", "mxc"}


def test_servingk_table_covers_the_tpu_tool():
    default = _modes_default(_tree("servingk_bench"))
    assert set(servingk_bench.TABLE) == set(default) | {"pretransposed"}
    assert servingk_bench.TABLE["pretransposed"].layout == 1


def test_passprice_table_is_the_tpu_ladder(tpu):
    ladder = tpu["passprice_bench"].LADDER
    assert [name.split("_")[0] for name, _ in ladder] == list(
        passprice_bench.TABLE)
    assert [name for name, _ in passprice_bench.RUNGS] == [
        name for name, _ in ladder]
    for (name, stages), var in zip(ladder, passprice_bench.TABLE.values()):
        word = 0
        for st in stages:
            word |= passprice_bench.STAGE_BITS[st]
        assert var.word == word, name
    assert passprice_bench.PRODS == ("prod_exact", "prod_serving")


def test_tables_name_the_eight_sites():
    sites = {v.site for table in ablate_common.tool_tables().values()
             for v in table.values()}
    assert len(sites) == 8
    for site in sites:
        path, line = site.split(":")
        src = (ROOT / path).read_text().splitlines()
        assert "pl.pallas_call(" in src[int(line) - 1], site


SHARED = [modes for modes in ablate_common.distinct_variants().values()
          if len(modes) > 1]


@pytest.mark.parametrize("modes", SHARED,
                         ids=["=".join(f"{t}:{m}" for t, m in ms)
                              for ms in SHARED])
def test_modes_sharing_a_call_are_equal_in_jax(tpu, modes):
    """Mode strings that map to one K8 call compute one function in JAX
    too, bit for bit, on 2 seeded cells."""
    layout = ablate_common.tool_tables()[modes[0][0]][modes[0][1]].layout
    x = [_bf16_jnp(a) for a in _inputs(2, seed=3, layout=layout)]
    outs = [np.asarray(jax_mode(tpu, tool, mode)(*x), np.float32)
            for tool, mode in modes]
    for (tool, mode), out in zip(modes[1:], outs[1:]):
        assert np.array_equal(out, outs[0]), (tool, mode)


@pytest.mark.parametrize("tool", sorted(ablate_common.tool_tables()))
def test_tool_runs_on_the_cpu(tool, capsys):
    mod = dict(attnk_bench=attnk_bench, attnk3_bench=attnk3_bench,
               servingk_bench=servingk_bench,
               passprice_bench=passprice_bench)[tool]
    assert mod.main(["--device", "cpu", "--cells", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = json.loads(out[-1])["rows"]
    assert [r["variant"] for r in rows] == list(mod.TABLE)
    for r in rows:
        assert r["ms"] is None and r["cpu_ms"] > 0 and r["bound_ms"] > 0
        assert sum(line.startswith(r["variant"] + " ") for line in out) == 1
    if tool == "passprice_bench":
        assert any(line.startswith("prod_exact ") for line in out)
        assert sum(line.startswith("  L") for line in out) == 16
    assert tuple(r["variant"] for r in rows if r["equal_to_prod"]) == \
        ablate_common.EQUAL_TO_PROD[tool]


def test_equal_to_prod_holds_the_all_on_words():
    """Every straight-layout mode whose word is its tier's all-on word,
    up to the value-neutral bits, is among those held equal to prod."""
    from mx_quantization_tpu_torch.ops.kernels import topk_ablate as ab
    all_on = dict(exact=ab.EXACT, serving=ab.SERVING)
    for tool, table in ablate_common.tool_tables().items():
        held = ablate_common.EQUAL_TO_PROD[tool]
        assert set(held) <= set(table), tool
        assert list(held) == [m for m in table if m in held], tool
        for mode, var in table.items():
            if var.layout == 0 and var.bfloat == 16 and \
                    var.word & ~ab.NEUTRAL == all_on[var.tier]:
                assert mode in held, (tool, mode)


def test_tools_without_a_card_refuse_the_gpu(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    assert attnk3_bench.main(["--cells", "1"]) == 2


def test_new_modules_import_no_jax():
    mods = ["mx_quantization_tpu_torch.ops.kernels.topk_ablate"] + [
        f"mx_quantization_tpu_torch.tools.{m}" for m in (
            "ablate_common", "attnk_bench", "attnk3_bench", "servingk_bench",
            "passprice_bench")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'mx_quantization_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
