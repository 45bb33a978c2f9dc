"""Kernels K9, K10 and K11's plain versions (``ops/kernels/mx_matmul.py``,
``kth_select.py``, ``lane_quantize.py``) against the TPU measurement tools
they replace (``tools/mx_matmul_ablation.py``, ``tools/kth_bench.py``,
``tools/lanequant_bench.py``), the port's tools of the same names on the
CPU, and the registry of TPU sites (``ops/kernels/__init__.py``
``TPU_SITES``) against every ``pl.pallas_call(`` of the repository.

The tools are loaded from their files as they are, with their side effects
held off: ``os.makedirs`` and the persistent-cache ``jax.config.update``
calls are no-ops during the loads, and JAX's config is checked unchanged
after.  ``kth_bench`` runs its whole benchmark at import (256 cells,
through a ``pallas_call`` without ``interpret=``, which fails on the CPU):
only its definitions are executed, the statements before its benchmark,
and the test asserts that the statements left out are exactly its trailing
``x =``, ``ref =`` and ``for``.  Its ``make(body)`` then runs in
interpret mode (``pl.pallas_call`` patched) at one cell (``G`` and
``CELLS`` set to 1).

Tolerances.  Everything is bit for bit except K9's product beyond one MX
block: the TPU kernel sums each 512-wide K tile in the MXU's order and the
port sums each block exactly and the blocks in K order, so the two may
differ by two orders of f32 summation, at most K 2^-24 sum_k |Q(A)_ik
Q(B)_kj| (``summation_bound``); the share of outputs that agree bit for
bit is recorded.
"""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.ops.kernels import TPU_SITES, tpu_site
from mx_quantization_tpu_torch.ops.kernels.kth_select import (
    N as KTH_N, STRATEGIES, keys_of, kth_select, kth_select_ref,
    search_steps)
from mx_quantization_tpu_torch.ops.kernels.lane_quantize import (
    lane_quantize, lane_quantize_ref)
from mx_quantization_tpu_torch.ops.kernels.mx_matmul import (
    mx_matmul, mx_matmul_ref, quantize_k, quantize_operands, summation_bound)
from mx_quantization_tpu_torch.ops.kernels.quantize import mx_quantize_ref
from mx_quantization_tpu_torch.tools import (ablate_common, kth_bench,
                                             lanequant_bench,
                                             mx_matmul_ablation)

ROOT = Path(__file__).resolve().parents[1]
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")
BLOCKS = (8, 16, 32, 64, 128)
ALL_FORMATS = ("int8", "int4", "int2", "fp8_e5m2", "fp8_e4m3", "fp6_e3m2",
               "fp6_e2m3", "fp4", "float16", "bfloat16")
LANE_FORMATS = ALL_FORMATS[:8]  # K1's: the int and MXFP grids


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several processes side by side; one torch thread
    each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exec_module(name, statements=None):
    """tools/<name>.py as a module; only ``statements`` of it (ast nodes)
    where given."""
    path = ROOT / "tools" / f"{name}.py"
    if statements is None:
        spec = importlib.util.spec_from_file_location(f"_tpu_tool_{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    mod = type(sys)(f"_tpu_tool_{name}")
    mod.__file__ = str(path)
    code = compile(ast.Module(body=statements, type_ignores=[]), str(path),
                   "exec")
    exec(code, mod.__dict__)
    return mod


def _kth_bench_definitions():
    """kth_bench's statements before its benchmark, having checked that
    the rest is exactly the benchmark: ``x = ...``, ``ref = None`` and the
    ``for`` over the strategies."""
    tree = ast.parse((ROOT / "tools" / "kth_bench.py").read_text())
    start = next(i for i, node in enumerate(tree.body)
                 if isinstance(node, ast.Assign) and
                 ast.unparse(node.targets[0]) == "x")
    left_out = tree.body[start:]
    assert [type(n).__name__ for n in left_out] == ["Assign", "Assign",
                                                    "For"]
    assert [ast.unparse(n.targets[0]) for n in left_out[:2]] == ["x", "ref"]
    assert ast.unparse(left_out[2].target) == "(name, bf)"
    return tree.body[:start]


@pytest.fixture(scope="module")
def tpu():
    """The three TPU tools, loaded with their side effects held off."""
    before = {key: getattr(jax.config, key) for key in CACHE_KEYS}
    made = []
    update = jax.config.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "makedirs", lambda *a, **kw: made.append(a))
        mp.setattr(jax.config, "update", lambda key, val: None
                   if key in CACHE_KEYS else update(key, val))
        mods = {name: _exec_module(name) for name in (
            "mx_matmul_ablation", "lanequant_bench")}
        mods["kth_bench"] = _exec_module("kth_bench",
                                         _kth_bench_definitions())
    assert {key: getattr(jax.config, key) for key in CACHE_KEYS} == before
    assert jax.config.update == update
    assert all(".cache" in str(a[0]) for a in made), made
    return mods


def _interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode (kth_bench passes no
    ``interpret=``)."""
    real = pl.pallas_call

    def pallas_call(*a, **kw):
        kw["interpret"] = True
        return real(*a, **kw)
    monkeypatch.setattr(pl, "pallas_call", pallas_call)


def _mixed(shape, seed, axis):
    """Seeded N(0, 1) values, each line along ``axis``'s other dimension
    scaled by 2^s for s in [-20, 20], with an all-zero and an
    all-subnormal line."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    lines = shape[1 - axis]
    scale = (2.0 ** rng.randint(-20, 21, size=lines)).astype(np.float32)
    x *= scale[None, :] if axis == 0 else scale[:, None]
    sl = (slice(None), 0) if axis == 0 else (0, slice(None))
    x[sl] = 0.0
    sl = (slice(None), 1) if axis == 0 else (1, slice(None))
    x[sl] = rng.randn(shape[axis]).astype(np.float32) * 1e-39
    return x


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ----------------------------------------------------------------------
# T1 / K9: the fused MX matmul
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_k9_quantize_matches_tpu(tpu, fmt):
    """Q along K, bit for bit against ``_quantize_block_values_axis0`` as
    ``_mm_kernel`` calls it (mbits only), every block and scale bits 8 and
    5, with an all-zero and an all-subnormal block."""
    from mx_quantization_tpu.ops.kernels.quantize import \
        _quantize_block_values_axis0
    mbits = format_params(fmt).mbits
    x = _mixed((256, 24), seed=len(fmt), axis=0)
    for bs in BLOCKS:
        for sb in (8, 5):
            want = _np(_quantize_block_values_axis0(
                jnp.asarray(x), bs, mbits, sb, jnp.bfloat16))
            got = quantize_k(torch.from_numpy(x), fmt, bs, sb, axis=0)
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.float().numpy(), want), (bs, sb)
            # A is quantized along its last axis: the same function
            got_a = quantize_k(torch.from_numpy(x.T.copy()), fmt, bs, sb,
                               axis=1)
            assert torch.equal(got_a, got.T), (bs, sb)


def _tpu_matmul(tpu, a, b, fmt, bs=32, sb=8):
    return np.asarray(tpu["mx_matmul_ablation"].mx_matmul_pallas(
        jnp.asarray(a), jnp.asarray(b), fmt, fmt, bs, sb))


@pytest.mark.parametrize("fmt,bs", [(f, 32) for f in ALL_FORMATS] +
                         [("int8", 8), ("int8", 128), ("float16", 16)])
def test_k9_product_bit_equal_at_one_block(tpu, fmt, bs):
    rng = np.random.RandomState(bs)
    a = _mixed((64, bs), seed=1, axis=1)
    b = (0.02 * rng.randn(bs, 48)).astype(np.float32)
    want = _tpu_matmul(tpu, a, b, fmt, bs)
    got = mx_matmul_ref(torch.from_numpy(a), torch.from_numpy(b), fmt, fmt,
                        bs)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "bfloat16", "float16"])
@pytest.mark.parametrize("M,K,N", [(64, 1152, 96), (72, 640, 40)])
def test_k9_product_within_summation_bound(tpu, fmt, M, K, N,
                                           record_property):
    """Beyond one block: within K 2^-24 sum |Q(A) Q(B)| of the TPU
    kernel (M and N off its 256 tiles; 640 is no multiple of its 512 K
    tile); the share of bit-equal outputs is recorded."""
    rng = np.random.RandomState(K)
    a = rng.randn(M, K).astype(np.float32)
    b = (0.02 * rng.randn(K, N)).astype(np.float32)
    want = _tpu_matmul(tpu, a, b, fmt)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = mx_matmul_ref(ta, tb, fmt, fmt).numpy()
    bound = summation_bound(*quantize_operands(ta, tb, fmt, fmt)).numpy()
    assert (np.abs(got - want) <= bound).all()
    record_property("bit_equal_share", float((got == want).mean()))
    if fmt != "float16":  # codes of at most 9 bits: every order is exact
        assert np.array_equal(got, want)


def test_k9_quantizes_every_format_on_an_integer_grid():
    """_mm_kernel passes only mbits: fp8_e4m3 goes onto the 5-bit integer
    grid, not the MXFP8 grid the port's K1 uses for that name."""
    x = torch.from_numpy(_mixed((16, 256), seed=3, axis=1))
    int5 = quantize_k(x, "fp8_e4m3", 32, 8, axis=1).float()
    mxfp8 = mx_quantize_ref(x, "fp8_e4m3", 32, 8, torch.bfloat16).float()
    assert not torch.equal(int5, mxfp8)
    # the integer grid: every value is q 2^(e - 3) with |q| <= 15
    blocks = x.reshape(16, 8, 32)
    e = ((blocks.view(torch.int32) & 0x7FFFFFFF).amax(-1) >> 23) - 127
    q = int5.reshape(16, 8, 32) / torch.exp2((e - 3).float())[..., None]
    live = (e > -127)[..., None].expand_as(q)
    assert torch.equal(q[live], q[live].round())
    assert q[live].abs().max() <= 15


def test_k9_plain_version_walks_the_blocks():
    """Each block's product exact in float64, rounded to f32 and added in
    K order: equal to that sum written out."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(9, 96).astype(np.float32))
    b = torch.from_numpy(rng.randn(96, 7).astype(np.float32))
    qa, qb = quantize_operands(a, b, "float16", "float16", 32, 8)
    want = torch.zeros(9, 7)
    for k0 in (0, 32, 64):
        want = want + (qa[:, k0:k0 + 32].double() @
                       qb[k0:k0 + 32].double()).float()
    assert torch.equal(mx_matmul(a, b, "float16", "float16", 32, 8), want)


@pytest.mark.parametrize("shape,block,match", [
    ((8, 96), 4, "blocks"), ((8, 96), 64, "multiple"),
    ((8, 100), 8, "multiple")])
def test_k9_raises_outside_its_domain(shape, block, match):
    a = torch.zeros(*shape)
    with pytest.raises(ValueError, match=match):
        mx_matmul(a, torch.zeros(shape[1], 4), block_size=block)


# ----------------------------------------------------------------------
# T2 / K10: the k-th key select
# ----------------------------------------------------------------------
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_k10_plain_matches_tpu_cell(tpu, monkeypatch, strategy):
    m = tpu["kth_bench"]
    monkeypatch.setattr(m, "G", 1, raising=False)
    monkeypatch.setattr(m, "CELLS", 1, raising=False)
    _interpret(monkeypatch)
    body = {"vpu": m.body_vpu, "mxu": m.body_mxu, "while": m.body_while}
    x = np.random.RandomState(0).randn(1, KTH_N, KTH_N).astype(np.float32)
    want = np.asarray(m.make(body[strategy])(jnp.asarray(x)))
    got = kth_select_ref(torch.from_numpy(x), m.K, strategy)
    assert np.array_equal(got.numpy(), want)


def _ties(seed):
    """Cells of few distinct values, negatives, +-0 and the extremes of
    the key range among them."""
    rng = np.random.RandomState(seed)
    vals = np.array([-3.0e38, -2.0, -1.0, -0.5, -0.0, 0.0, 1.5, 3.0e38],
                    np.float32)
    return torch.from_numpy(vals[rng.randint(0, len(vals),
                                             (3, KTH_N, KTH_N))])


def _kthvalue(x, k):
    """``torch.kthvalue`` on the keys: each row's k-th largest, broadcast
    as K10 writes it (the port's tool times this call at k = 154)."""
    return torch.kthvalue(keys_of(x), KTH_N - k + 1, dim=-1).values.to(
        torch.float32)[..., None].expand(x.shape)


@pytest.mark.parametrize("k", [1, 154, 256])
def test_k10_strategies_equal_kthvalue(k):
    for x in (_ties(k), torch.from_numpy(
            np.random.RandomState(k).randn(2, KTH_N, KTH_N)
            .astype(np.float32))):
        want = _kthvalue(x, k)
        if k == kth_bench.K:
            assert torch.equal(kth_bench.library(x), want)
        for strategy in STRATEGIES:
            assert torch.equal(kth_select(x, k, strategy), want), strategy
        assert (search_steps(x, k) <= 17).all()


def test_k10_raises_outside_its_domain():
    with pytest.raises(ValueError, match="cells"):
        kth_select(torch.zeros(1, 128, 256), 3)
    with pytest.raises(ValueError, match="k must"):
        kth_select(torch.zeros(1, 256, 256), 257)
    with pytest.raises(ValueError, match="strategy"):
        kth_select(torch.zeros(1, 256, 256), 3, "sort")


# ----------------------------------------------------------------------
# T3 / K11: the lane-axis MX quantize
# ----------------------------------------------------------------------
def _tpu_lanes(tpu, x, fmt, bs, out_dtype, flush, bfloat, fn=None):
    fn = fn or tpu["lanequant_bench"].mx_quantize_lanes
    jx = jnp.asarray(x)
    return _np(fn(jx, fmt, bs, 8, jnp.float32 if out_dtype is torch.float32
                  else jnp.bfloat16, 256, flush, bfloat))


def _lane_case(i):
    """(bfloat, flush, in dtype, out dtype) of case i: every combination
    over the cases of a test."""
    return ((0, 16)[i % 2], bool(i // 2 % 2),
            (torch.float32, torch.bfloat16)[i // 4 % 2],
            (torch.bfloat16, torch.float32)[i // 8 % 2])


def _lane_input(shape, seed, dtype):
    x = torch.from_numpy(_mixed(shape, seed, axis=1)).to(dtype)
    return x, x.float().numpy() if dtype is torch.float32 else \
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("i,fmt", list(enumerate(LANE_FORMATS)) +
                         [(8 + i, f) for i, f in enumerate(LANE_FORMATS)])
def test_k11_plain_matches_tpu_formats(tpu, i, fmt):
    """Each format in two of the 16 (bfloat, flush, in, out) cases, block
    32, K = 256 (the probe's 128-lane path)."""
    bfloat, flush, din, dout = _lane_case(i)
    x, jx = _lane_input((32, 256), i, din)
    want = _tpu_lanes(tpu, jx, fmt, 32, dout, flush, bfloat)
    got = lane_quantize_ref(x, fmt, 32, 8, dout, flush, bfloat)
    assert got.dtype == dout
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("bs,K", [(bs, K) for K in (96, 384)
                                  for bs in BLOCKS if K % bs == 0])
def test_k11_plain_matches_tpu_blocks(tpu, bs, K):
    """Every block at K = 384 (K > 128, a multiple of 128) and, where it
    divides, K = 96 (the probe's full-width path)."""
    fmt = ("int8", "fp8_e4m3")[bs // 16 % 2]
    bfloat, flush, din, dout = _lane_case(bs + K)
    x, jx = _lane_input((16, K), bs, din)
    want = _tpu_lanes(tpu, jx, fmt, bs, dout, flush, bfloat)
    got = lane_quantize_ref(x, fmt, bs, 8, dout, flush, bfloat)
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_k11_nomax_matches_tpu_nomax(tpu, monkeypatch, fmt):
    """The probe reads ``NOMAX`` when it traces: its function under a new
    ``jax.jit`` with the variable set."""
    lanes = tpu["lanequant_bench"].mx_quantize_lanes
    fresh = jax.jit(lanes.__wrapped__, static_argnames=(
        "elem_format", "block_size", "scale_bits", "out_dtype", "tile_rows",
        "flush", "bfloat"))
    monkeypatch.setenv("NOMAX", "1")
    x, jx = _lane_input((16, 256), 9, torch.float32)
    want = _tpu_lanes(tpu, jx, fmt, 32, torch.bfloat16, True, 16, fresh)
    got = lane_quantize_ref(x, fmt, 32, 8, torch.bfloat16, True, 16,
                            nomax=True)
    assert np.array_equal(got.float().numpy(), want)
    assert not torch.equal(got, lane_quantize_ref(x, fmt, 32, 8,
                                                  torch.bfloat16, True, 16))


@pytest.mark.parametrize("fmt", LANE_FORMATS)
def test_k11_plain_equals_k1_plain(fmt):
    for i in range(16):
        bfloat, flush, din, dout = _lane_case(i)
        x = torch.from_numpy(_mixed((8, 256), i, axis=1)).to(din)
        for bs in BLOCKS:
            assert torch.equal(
                lane_quantize(x, fmt, bs, 8, dout, flush, bfloat),
                mx_quantize_ref(x, fmt, bs, 8, dout, flush, bfloat))


@pytest.mark.parametrize("block", [1, 2, 4])
def test_k11_raises_at_small_blocks(block):
    with pytest.raises(ValueError, match="blocks"):
        lane_quantize(torch.zeros(4, 64), block_size=block)


# ----------------------------------------------------------------------
# the port's tools on the CPU, and the registry
# ----------------------------------------------------------------------
def _run_tool(mod, argv, capsys):
    assert mod.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    return out, json.loads(out[-1])


def test_mx_matmul_ablation_tool_runs_on_the_cpu(capsys):
    out, res = _run_tool(mx_matmul_ablation,
                         ["--rows", "16"], capsys)
    assert res["device"] == "not measured (CPU)"
    assert [r["linear"] for r in res["rows"]] == ["qkv", "proj", "fc1", "fc2"]
    for r in res["rows"]:
        assert r["ms"] is None and r["cpu_ms"] > 0 and r["bound_ms"] > 0
        assert r["within_sum_bound"] and r["max_diff_unfused"] <= \
            r["max_sum_bound"]
    assert res["rows"][0]["shape"] == [16, 1152, 3456]


def test_kth_bench_tool_runs_on_the_cpu(capsys):
    out, res = _run_tool(kth_bench, ["--cells", "2"], capsys)
    rows = res["rows"]
    assert [r["variant"] for r in rows] == [*STRATEGIES, "kthvalue"]
    for r in rows[:-1]:
        assert r["equal_to_kthvalue"] and r["cpu_ms"] > 0 and r["ms"] is None
        assert r["bound_by"] == "bytes"
    assert rows[0]["steps"] == 34 and rows[2]["steps"] <= 34


@pytest.mark.parametrize("nomax", [False, True])
def test_lanequant_tool_runs_on_the_cpu(capsys, nomax):
    out, res = _run_tool(lanequant_bench, ["--rows", "8"] +
                         ["--nomax"] * nomax, capsys)
    assert len(res["rows"]) == 2 * 2 * 2
    for r in res["rows"]:
        assert r["equal_to_k1"] is not nomax and r["ms"] is None
        assert r["bound_by"] == "bytes"


def test_measure_tools_without_a_card_refuse_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    for mod in (mx_matmul_ablation, kth_bench, lanequant_bench):
        assert mod.main([]) == 2


def _pallas_sites():
    """Every ``pl.pallas_call(`` line outside the port: path:line."""
    sites = []
    for path in sorted((ROOT / "mx_quantization_tpu").rglob("*.py")) + \
            sorted((ROOT / "tools").glob("*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if "pl.pallas_call(" in line:
                sites.append(f"{path.relative_to(ROOT)}:{n}")
    return sites


def test_registry_names_every_tpu_site_once():
    sites = _pallas_sites()
    assert len(sites) == 18 and len(set(sites)) == 18
    assert sorted(TPU_SITES) == sorted(sites)
    for site in TPU_SITES:
        path, line = site.split(":")
        src = (ROOT / path).read_text().splitlines()
        assert "pl.pallas_call(" in src[int(line) - 1], site
    # the attention-ablation tools' variants name K8's eight sites
    k8 = {v.site for table in ablate_common.tool_tables().values()
          for v in table.values()}
    assert k8 == {s for s, k in TPU_SITES.items() if k == "ablate_attention"}
    assert tpu_site("mx_matmul") == "tools/mx_matmul_ablation.py:97"
    with pytest.raises(ValueError):
        tpu_site("ablate_attention")


def test_registry_names_wrappers_that_count_launches():
    from mx_quantization_tpu_torch.ops.kernels import (
        kth_select as ks, lane_quantize as lq, ln_modulate_quantize as lnq,
        mx_matmul as mm, quantize, topk_ablate, topk_attention)
    mods = (ks, lq, lnq, mm, quantize, topk_ablate, topk_attention)
    for name in set(TPU_SITES.values()):
        fn = next(getattr(m, name) for m in mods if hasattr(m, name))
        assert isinstance(fn.launches, int), name


def test_new_modules_import_no_jax():
    mods = [f"mx_quantization_tpu_torch.ops.kernels.{m}" for m in (
        "mx_matmul", "kth_select", "lane_quantize")] + [
        f"mx_quantization_tpu_torch.tools.{m}" for m in (
            "mx_matmul_ablation", "kth_bench", "lanequant_bench")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'mx_quantization_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("source", ["mx_matmul_ablation.cu", "kth_select.cu",
                                    "lane_quantize.cu"])
def test_kernel_sources_call_no_library(source):
    """K9-K11 are written out: their sources include only the CUDA
    runtime's headers and the port's own, and name no library call."""
    src = (ROOT / "mx_quantization_tpu_torch" / "csrc" / source).read_text()
    includes = set(re.findall(r'#include [<"]([^>"]+)[>"]', src))
    assert includes <= {"mx_common.cuh", "cuda_runtime.h", "stdint.h"}
    assert not re.search(r"cublas|cutlass|thrust|cub::|kthvalue|topk|sort",
                         src, re.I)
