"""Kernel K8's plain version (``ops/kernels/topk_ablate.py``) against the
TPU attention-ablation tools it replaces (``tools/attnk_bench.py``,
``tools/attnk3_bench.py``, ``tools/servingk_bench.py``,
``tools/passprice_bench.py``), mode by mode and site by site, on the CPU.

The tools are loaded from their files as they are.  Importing one creates
a cache folder, turns on JAX's persistent compilation cache for the
process and (``attnk_bench``) times its kernels unless ``SKIP_BASE=1``:
the ``tpu`` fixture sets ``SKIP_BASE``, makes ``os.makedirs`` and those
three ``jax.config.update`` calls no-ops during the imports, and then
checks that JAX's config is as it was.

Per mode, every mode string each tool runs goes through the port's plain
version (the tool's table in ``mx_quantization_tpu_torch/tools/``) and the
tool's own cell function, jitted once and called on 2 seeded cells
(``make_batched``, which has no cell function, through its
``pallas_call`` in interpret mode at 4 cells, one grid step).  Per site,
each of the eight ``pallas_call`` sites runs once through its own
``make*()`` in interpret mode, the tool's ``G`` and ``CELLS`` set to 1.

Tolerance.  Outputs that agree bit for bit pass at once.  Elsewhere the
probabilities are read through probes: the same q and k with v set to
one-hot columns (v[n, d] = 1 where n = 72 p + d, p = 0 .. 3), so that
output row n holds the probabilities (or, below L07 of the ladder, the
scores) that meet v in the PV product; NOAT's row j holds column j.
XLA's float32 exp and its orders of summation (the dot products of
unquantized operands, the softmax sum, PV) differ from the port's in the
last bits; where that puts a probability across a rounding boundary it
lands one step of its grid away (the MX grid of its 32-block with AQ, a
bf16 step otherwise).  A row whose probabilities all match may differ
from JAX's by one bf16 ulp of the output (rtol 2^-7, the ulp's largest
share of a value, and atol 2e-5: the RNE cast of f32 sums taken in other
orders); a row where they differ may
differ in at most two probabilities, each by one step, and by those steps
times max |v| beyond that; at most one row in a hundred (and one at the
least) may differ so.  The modes differ in how often this happens, not in
the rule: most agree bit for bit.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mx_quantization_tpu_torch.ops.kernels import topk_ablate as ab
from mx_quantization_tpu_torch.ops.kernels.topk_attention import \
    fused_topk_attention_ref
from mx_quantization_tpu_torch.tools import (attnk3_bench, attnk_bench,
                                             passprice_bench, servingk_bench)
from mx_quantization_tpu_torch.tools.ablate_common import D_PRET, call

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("attnk_bench", "attnk3_bench", "servingk_bench", "passprice_bench")
TABLES = dict(attnk_bench=attnk_bench.TABLE, attnk3_bench=attnk3_bench.TABLE,
              servingk_bench=servingk_bench.TABLE,
              passprice_bench=passprice_bench.TABLE)
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")
N, D = 256, 72


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version works on (cells, 256, 256) score tensors that torch
    would spread over every core; the suite runs several processes side by
    side, where that only contends.  One torch thread per process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu():
    """The four TPU tools, imported with their side effects held off."""
    before = {key: getattr(jax.config, key) for key in CACHE_KEYS}
    made = []
    update = jax.config.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKIP_BASE", "1")
        mp.setattr(os, "makedirs", lambda *a, **kw: made.append(a))
        mp.setattr(jax.config, "update", lambda key, val: None
                   if key in CACHE_KEYS else update(key, val))
        mods = {name: _load(name) for name in TOOLS}
    assert {key: getattr(jax.config, key) for key in CACHE_KEYS} == before
    assert jax.config.update == update
    assert all(".cache" in str(a[0]) for a in made), made
    return mods


def _inputs(cells, seed, layout=0):
    rng = np.random.RandomState(seed)
    qk = (cells, N, D) if layout == 0 else (cells, D_PRET, N)
    return (rng.randn(*qk).astype(np.float32),
            rng.randn(*qk).astype(np.float32),
            rng.randn(cells, N, D).astype(np.float32))


def _bf16_jnp(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _bf16_torch(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _cellwise(cell):
    """A tool's cell function (q, k, v, o_ref) as a function of (cells, ...)
    arrays, jitted once, one cell per call."""
    def one(q, k_, v):
        o = {}
        cell(q, k_, v, o)
        return o[0]
    fn = jax.jit(one)
    return lambda q, k_, v: jnp.stack([fn(q[c], k_[c], v[c])
                                       for c in range(q.shape[0])])


def _cell_pret(sk):
    """``servingk_bench.probe_pretransposed``'s ``cell_pret`` rebuilt line
    for line from the same JAX helpers (the closure lives inside a
    function that times itself, so it cannot be reached)."""
    from mx_quantization_tpu.ops.kernels.topk_attention import (
        _exp_sign_approx, _quant_axis0)
    BS, MBITS, SB, K, S, SCALE = sk.BS, sk.MBITS, sk.SB, sk.K, sk.S, sk.SCALE

    def cell_pret(qt, kt, v_nd, o_ref, c):
        def quant_side(xt):
            vals, exps = _quant_axis0(xt.astype(jnp.float32), BS, MBITS, SB)
            return vals, _exp_sign_approx(vals, exps, BS)
        qv, aq = quant_side(qt)
        kv, ak = quant_side(kt)
        v_q, _ = _quant_axis0(v_nd.astype(jnp.float32), BS, MBITS, SB)
        dn = (((0,), (0,)), ((), ()))
        s_raw = jax.lax.dot_general(kv, qv, dn,
                                    preferred_element_type=jnp.float32)
        s_sel = jax.lax.dot_general(ak, aq, dn,
                                    preferred_element_type=jnp.float32)
        keys = sk._mono_keys_top(s_sel, 24)
        kth, _ = sk._kth_keys(keys, K, n_iters=8, lo_init=-128, hi_init=127)
        sel = keys >= kth
        neg = jnp.full((S, N), -3.0e38, jnp.float32)
        s_true = s_raw * SCALE
        masked = jnp.where(sel, s_true, neg)
        m = jnp.max(masked, axis=0, keepdims=True)
        e = jnp.exp(masked - m)
        at_q = (e / jnp.sum(e, axis=0, keepdims=True)).astype(jnp.bfloat16)
        out = jax.lax.dot_general(at_q, v_q, dn,
                                  preferred_element_type=jnp.float32)
        o_ref[c] = out.astype(jnp.bfloat16)
    return cell_pret


def _pret_call(sk, cells):
    """``probe_pretransposed``'s ``pallas_call`` (its ``run``) rebuilt with
    ``cell_pret`` at ``cells`` cells, one grid step, in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    cell_pret = _cell_pret(sk)

    def kern(q_ref, k_ref, v_ref, o_ref):
        for c in range(cells):
            cell_pret(q_ref[c], k_ref[c], v_ref[c], o_ref, c)

    @jax.jit
    def run(q, k_, v):
        return pl.pallas_call(
            kern, grid=(1,),
            in_specs=[pl.BlockSpec((cells, D_PRET, N), lambda g: (g, 0, 0),
                                   memory_space=pltpu.VMEM)] * 2 + [
                pl.BlockSpec((cells, N, D), lambda g: (g, 0, 0),
                             memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((cells, N, D), lambda g: (g, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((cells, N, D), jnp.bfloat16),
            interpret=True)(q, k_, v)
    return run


def jax_mode(tpu, tool, mode):
    """The TPU tool's function of one mode string on (cells, ...) arrays."""
    m = tpu[tool]
    if tool == "attnk_bench":
        if mode == "i16":
            return _cellwise(lambda q, k_, v, o: m._cell_i16(q, k_, v, o, 0))
        if mode.startswith("trans-"):
            return _cellwise(lambda q, k_, v, o: m._cell_trans(
                q, k_, v, o, 0, mode[len("trans-"):]))
        return _cellwise(lambda q, k_, v, o: m._cell(q, k_, v, o, 0, mode))
    if tool == "passprice_bench":
        st = {name.split("_")[0]: s for name, s in m.LADDER}[mode]
        return _cellwise(lambda q, k_, v, o: m._cell(q, k_, v, o, 0, st))
    if mode == "pretransposed":
        cell_pret = _cell_pret(m)
        return _cellwise(lambda q, k_, v, o: cell_pret(q, k_, v, o, 0))
    return _cellwise(lambda q, k_, v, o: m._cell(q, k_, v, o, 0, mode))


def _probes(cells):
    """One-hot v's whose outputs together hold every key's probability."""
    out = []
    for p in range(-(-N // D)):
        vp = np.zeros((cells, N, D), np.float32)
        for d in range(D):
            if D * p + d < N:
                vp[:, D * p + d, d] = 1.0
        out.append(vp)
    return out


def _probed(fn, q, k_, cells):
    rows = [np.asarray(fn(q, k_, vp), np.float32) for vp in _probes(cells)]
    return np.concatenate(rows, axis=-1)[..., :N]


def check(port, want_fn, q, k_, v, var):
    """The module docstring's criterion; port and want_fn map float32
    numpy (q, k, v) to float32 numpy outputs."""
    got, want = port(q, k_, v), want_fn(q, k_, v)
    assert got.shape == want.shape
    if np.array_equal(got, want):
        return
    cells = q.shape[0]
    pg, pw = _probed(port, q, k_, cells), _probed(want_fn, q, k_, cells)
    flip = (pg != pw).any(-1)
    close = np.isclose(got, want, rtol=2.0 ** -7, atol=2e-5).all(-1)
    assert (close | flip).all(), \
        f"{(~close & ~flip).sum()} rows outside tolerance, same probabilities"
    assert flip.sum() <= max(1, flip.size // 100), f"{flip.sum()} rows flip"
    if not flip.any():
        return
    hi = np.maximum(np.abs(pg), np.abs(pw))[flip]
    if var.word & ab.AQ:
        blk = hi.reshape(len(hi), -1, 32).max(-1)
        step = np.repeat(blk, 32, axis=-1) * 2.0 ** -6
    else:
        step = hi * 2.0 ** -7
    dp = np.abs(pg - pw)[flip]
    assert ((dp > 0).sum(-1) <= 2).all()
    assert (dp <= step).all()
    vmax = np.abs(v).max(axis=(1, 2))
    vm = np.repeat(vmax[:, None], N, axis=1)[flip] * (1 + 2.0 ** -6)
    err = np.abs(got - want)[flip].max(-1)
    assert (err <= dp.sum(-1) * vm + 2e-5 +
            2.0 ** -7 * np.abs(want[flip]).max(-1)).all()


def _port(var):
    def fn(q, k_, v):
        return call(var, *(_bf16_torch(x) for x in (q, k_, v)),
                    plain=True).float().numpy()
    return fn


def _jax(fn):
    return lambda q, k_, v: np.asarray(
        fn(*(_bf16_jnp(x) for x in (q, k_, v))).astype(jnp.float32))


MODES = [(tool, mode) for tool in TOOLS for mode in TABLES[tool]
         if mode != "batched"]


@pytest.mark.parametrize("tool,mode", MODES)
def test_mode_matches_tpu_cell(tpu, tool, mode):
    var = TABLES[tool][mode]
    q, k_, v = _inputs(2, seed=len(mode), layout=var.layout)
    check(_port(var), _jax(jax_mode(tpu, tool, mode)), q, k_, v, var)


def test_batched_mode_matches_tpu_pallas_call(tpu, monkeypatch):
    """``make_batched`` at 4 cells in one grid step: its 16-bit keys' k-th
    over each key column of the 4 cells' stacked rows (port: group 4)."""
    m = tpu["attnk_bench"]
    monkeypatch.setattr(m, "G", 4)
    monkeypatch.setattr(m, "CELLS", 4)
    _interpret(monkeypatch)
    var = attnk_bench.TABLE["batched"]
    assert var.group == 4
    q, k_, v = _inputs(4, seed=7)
    check(_port(var), _jax(m.make_batched()), q, k_, v, var)


def _interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode (attnk_bench and attnk3_bench
    pass no ``interpret=``)."""
    real = pl.pallas_call

    def pallas_call(*a, **kw):
        kw["interpret"] = True
        return real(*a, **kw)
    monkeypatch.setattr(pl, "pallas_call", pallas_call)


SITES = {  # site: (tool, how to build its call, the port's variant)
    "tools/attnk_bench.py:119": ("attnk_bench", lambda m: m.make("full"),
                                 attnk_bench.TABLE["full"]),
    "tools/attnk_bench.py:258": ("attnk_bench", lambda m: m.make_i16(),
                                 attnk_bench.TABLE["i16"]),
    "tools/attnk_bench.py:341": ("attnk_bench", lambda m: m.make_batched(),
                                 attnk_bench.TABLE["batched"]),
    "tools/attnk_bench.py:464": ("attnk_bench", lambda m: m.make_trans("full"),
                                 attnk_bench.TABLE["trans-full"]),
    "tools/attnk3_bench.py:264": ("attnk3_bench", lambda m: m.make("base"),
                                  attnk3_bench.TABLE["base"]),
    "tools/servingk_bench.py:136": ("servingk_bench",
                                    lambda m: m.make("base"),
                                    servingk_bench.TABLE["base"]),
    "tools/servingk_bench.py:250": ("servingk_bench",
                                    lambda m: _pret_call(m, 1),
                                    servingk_bench.TABLE["pretransposed"]),
    "tools/passprice_bench.py:182": (
        "passprice_bench", lambda m: m.make(dict(m.LADDER)[
            "L15_+tie_rank=EXACT"]), passprice_bench.TABLE["L15"]),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_pallas_site_matches(tpu, monkeypatch, site):
    """Each ``pallas_call`` site once through its own ``make*()`` (the
    pretransposed probe's rebuilt, ``_pret_call``) in interpret mode, one
    cell (the tool's G and CELLS set to 1)."""
    tool, make, var = SITES[site]
    assert var.site == site
    m = tpu[tool]
    monkeypatch.setattr(m, "G", 1)
    monkeypatch.setattr(m, "CELLS", 1)
    _interpret(monkeypatch)
    q, k_, v = _inputs(1, seed=11, layout=var.layout)
    check(_port(var), _jax(make(m)), q, k_, v, var)


@pytest.mark.parametrize("tier", ["exact", "serving"])
def test_all_on_words_equal_k3_plain(tier):
    """EXACT and SERVING are the production pipeline: bit for bit K3's plain
    version at ex_pred, key_bits 8, bfloat 16, bf16 output."""
    q, k_, v = (_bf16_torch(x) for x in _inputs(3, seed=5))
    word = ab.EXACT if tier == "exact" else ab.SERVING
    got = ab.ablate_attention_ref(q, k_, v, passes=word, k=154,
                                  scale=D ** -0.5)
    want = fused_topk_attention_ref(
        *(t.reshape(3, 1, N, D) for t in (q, k_, v)), k=154,
        scale=D ** -0.5, key_bits=8, bfloat=16, out_dtype=torch.bfloat16,
        contract=tier).reshape(3, N, D)
    assert torch.equal(got, want)
