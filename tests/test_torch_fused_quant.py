"""The port's fused producer quantizes against the JAX package's Pallas
kernels in interpret mode: K5 (LN, adaLN modulate and MX quantize in one
pass, ``ln_modulate_quantize``) against ``ln_modulate_quantize_pallas``, K6
(GELU and MX quantize, ``gelu_quantize``) against ``gelu_quantize_pallas``,
the serving gate ``gelu_quantize_serving``, and PixArt's ``fuse_gelu``
block against JAX's.

Tolerances, both ``_assert_grid_tie_parity`` of tests/test_gelu_fusion.py
(at most 0.1% of the elements differ, each by at most one grid step):
  * K5 is bit-equal but for near-tie flips.  The port takes the LN mean and
    variance in the kernel's warp order (``fastquant.lane_sum``), XLA in
    its own, so a statistic can differ in its last bit; where a modulated
    value then sits at a rounding tie of the bf16 round or of the MX grid,
    it lands one step away.  At these seeds a few cases show one such flip.
  * K6: torch's tanh and erfc and XLA's differ by ulps on the CPU, so a
    GELU output at a tie flips the same way (JAX's own test holds its
    kernel to the XLA chain by this criterion).
Inputs stay in a moderate range: XLA on the CPU flushes subnormals, torch
keeps them.
"""

import dataclasses
import importlib
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mx_quantization_tpu.models.pixart as jax_pixart
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.models.pixart import \
    PixArtQuantConfig as JaxQuantConfig
from mx_quantization_tpu.models.stacked import unstack_block
from mx_quantization_tpu.ops.kernels.quantize import (
    gelu_quantize_pallas, ln_modulate_quantize_pallas)
from mx_quantization_tpu.workloads.pixart import pixart_mx_specs as jax_specs

import mx_quantization_tpu_torch.models.pixart as port_pixart
from mx_quantization_tpu_torch.models.pixart import PixArtQuantConfig
from mx_quantization_tpu_torch.ops.fastquant import (
    gelu_quantize_serving, k5_row_sum, lane_sum)
from mx_quantization_tpu_torch.ops.kernels.ln_modulate_quantize import (
    ln_modulate_quantize, ln_modulate_quantize_ref)
from mx_quantization_tpu_torch.ops.kernels.quantize import (
    gelu_quantize, gelu_quantize_ref)
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs
from mx_quantization_tpu_torch.workloads.pixart import pixart_mx_specs
from test_gelu_fusion import _assert_grid_tie_parity, _interpret_gelu_serving
from test_torch_dit import _check, _np
from test_torch_pixart import QKW as PIXART_QKW
from test_torch_pixart import answer_jax, models, record_calls  # noqa: F401

FORMATS = ["int8", "int4", "fp8_e4m3"]
PORT_LINEAR = importlib.import_module("mx_quantization_tpu_torch.ops.linear")


def _ln_inputs(C, seed, subnormal_block=False):
    rng = np.random.RandomState(seed)
    x = (3 * rng.randn(2, 50, C) + 0.5).astype(np.float32)
    shift = (0.3 * rng.randn(2, C)).astype(np.float32)
    scale = (0.3 * rng.randn(2, C)).astype(np.float32)
    if subnormal_block:
        # 1 + scale = 0 on the first block of row 0: the modulated values
        # are the shift there, 1e-39, a block that flush zeroes
        scale[0, :32], shift[0, :32] = -1.0, 1e-39
    return x, shift, scale


def _cases(crossed, each_other_format):
    """Every combination of ``crossed`` for int8, and the ``each_other_format``
    combinations for the other formats: the int8 cross covers each axis,
    and the other formats differ from int8 only in their grid (the card's
    tests run the whole cross bit for bit)."""
    cases = [("int8", *c) for c in itertools.product(*crossed)]
    return cases + [(f, *c) for f in FORMATS[1:] for c in each_other_format]


# (fmt, C, bfloat, flush, dtype); 1280 is the widest row the kernel keeps
# in registers, 2304 a row it keeps in shared memory
K5_CASES = _cases(([96, 1152], [0, 16], [False, True],
                   ["float32", "bfloat16"]),
                  [(96, 16, True, "float32"), (96, 0, False, "bfloat16")]) + [
    ("int8", 1280, 16, False, "bfloat16"), ("int8", 2304, 0, True, "float32"),
    ("fp8_e4m3", 1280, 0, True, "float32"),
    ("fp8_e4m3", 2304, 16, False, "bfloat16")]


@pytest.mark.parametrize(
    "fmt,C,bfloat,flush,dtype", K5_CASES,
    ids=[f"{d}-{fl}-{b}-{f}-{c}" for f, c, b, fl, d in K5_CASES])
def test_k5_plain_matches_jax_kernel(C, fmt, bfloat, flush, dtype):
    # N = 50 rows per batch row: no multiple of any tile
    x, shift, scale = _ln_inputs(C, seed=C + 7 * bfloat + flush)
    kw = dict(elem_format=fmt, block_size=32, scale_bits=8, flush=flush,
              bfloat=bfloat)
    want = ln_modulate_quantize_pallas(jnp.asarray(x).astype(dtype),
                                       jnp.asarray(shift), jnp.asarray(scale),
                                       **kw)
    got = ln_modulate_quantize_ref(torch.from_numpy(x).to(getattr(torch,
                                                                  dtype)),
                                   torch.from_numpy(shift),
                                   torch.from_numpy(scale), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_grid_tie_parity(want, _np(got))


def _k5_order_sum(row):
    """K5's sum of a float32 row, step by step as the kernel's note states:
    lane l takes the 8-channel chunks l + 32 j, sums each as the tree
    ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)) and the chunk sums
    in j order (a chunk past the row's end is zeros); the lanes then add by
    an xor butterfly."""
    chunks, rounds = len(row) // 8, -(-len(row) // 256)
    lanes = []
    for lane in range(32):
        s = None
        for j in range(rounds):
            k = lane + 32 * j
            c = row[8 * k:8 * k + 8] if k < chunks else np.zeros(8, np.float32)
            t = ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]))
            s = t if s is None else s + t
        lanes.append(s)
    for off in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
    return lanes[0]


@pytest.mark.parametrize("C", [96, 288, 1152])
def test_k5_row_sum_is_the_kernels_order(C):
    """``fastquant.k5_row_sum`` against the order spelled out (288: a last
    round of 4 chunks), bit for bit; at these magnitudes the order shows:
    ``lane_sum``'s differs on some rows."""
    rng = np.random.RandomState(C)
    rows = (rng.randn(64, C) * 10.0 ** rng.randint(-3, 4, (64, C))).astype(
        np.float32)
    got = k5_row_sum(torch.from_numpy(rows))[:, 0].numpy()
    want = np.array([_k5_order_sum(r) for r in rows], np.float32)
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    other = lane_sum(torch.from_numpy(rows))[:, 0].numpy()
    assert (other != got).any()


def test_k5_flushes_a_subnormal_block_like_jax():
    x, shift, scale = _ln_inputs(96, seed=3, subnormal_block=True)
    want = ln_modulate_quantize_pallas(jnp.asarray(x), jnp.asarray(shift),
                                       jnp.asarray(scale), flush=True)
    got = ln_modulate_quantize_ref(*map(torch.from_numpy, (x, shift, scale)),
                                   flush=True)
    assert (got[0, :, :32] == 0).all()
    _assert_grid_tie_parity(want, _np(got))


def test_k5_wrapper_uses_plain_only_on_cpu():
    x, shift, scale = map(torch.from_numpy, _ln_inputs(96, seed=4))
    before = ln_modulate_quantize.launches
    got = ln_modulate_quantize(x, shift, scale, bfloat=16)
    assert ln_modulate_quantize.launches == before  # nothing launched
    assert torch.equal(got, ln_modulate_quantize_ref(x, shift, scale,
                                                     bfloat=16))
    meta = torch.empty(2, 50, 96, device="meta")
    with pytest.raises(ValueError):
        ln_modulate_quantize(meta, shift.to("meta"), scale.to("meta"))


# (fmt, approximate, bfloat, flush)
K6_CASES = _cases(([True, False], [0, 16, 32], [False, True]),
                  [(True, 16, False), (False, 32, True)])


@pytest.mark.parametrize(
    "fmt,approximate,bfloat,flush", K6_CASES,
    ids=[f"{fl}-{b}-{f}-{a}" for f, a, b, fl in K6_CASES])
def test_k6_plain_matches_jax_kernel(approximate, fmt, bfloat, flush):
    """bf16 input (the fc1 output of the bf16 serving path)."""
    rng = np.random.RandomState(bfloat + flush)
    x = (2 * rng.randn(4, 64, 256)).astype(np.float32)
    kw = dict(elem_format=fmt, block_size=32, scale_bits=8, flush=flush,
              bfloat=bfloat, approximate=approximate)
    want = gelu_quantize_pallas(jnp.asarray(x).astype(jnp.bfloat16), **kw)
    got = gelu_quantize_ref(torch.from_numpy(x).to(torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    _assert_grid_tie_parity(want, _np(got))


@pytest.mark.parametrize("approximate", [True, False])
def test_k6_f32_input_matches_jax_kernel(approximate):
    x = (2 * np.random.RandomState(5).randn(2, 100, 128)).astype(np.float32)
    kw = dict(bfloat=16, approximate=approximate)
    _assert_grid_tie_parity(
        gelu_quantize_pallas(jnp.asarray(x), **kw),
        _np(gelu_quantize_ref(torch.from_numpy(x), **kw)))


def test_k6_wrapper_and_serving_gate():
    specs = dit_mx_specs()
    big = torch.from_numpy(np.random.RandomState(6).randn(
        4, 64, 256).astype(np.float32)).to(torch.bfloat16)  # 2^16 elements
    before = gelu_quantize.launches
    got = gelu_quantize_serving(big, specs)
    assert gelu_quantize.launches == before  # the plain version on the CPU
    assert torch.equal(got, gelu_quantize_ref(big, bfloat=16))
    assert torch.equal(got, gelu_quantize(big, bfloat=16))
    # JAX's gate: fewer than 2^16 elements or a ragged last axis -> None
    assert gelu_quantize_serving(big[:3], specs) is None
    assert gelu_quantize_serving(torch.zeros(4, 64, 16, 24), specs) is None
    with pytest.raises(ValueError):
        gelu_quantize(torch.empty(4, 64, device="meta"))


def test_pixart_fuse_gelu_block_matches_jax(models,  # noqa: F811
                                            monkeypatch):
    """One serving-tier PixArt block with ``fuse_gelu``: the port's block
    against JAX's, JAX's quantizes, attention calls and fused GELU quantize
    answered by the port's (each checked first: JAX's K6 in interpret mode
    on the port's input, as JAX's own test runs it, by the K6 criterion).
    The exact tier never takes K6."""
    jcfg, jparams, _, model = models
    rng = np.random.RandomState(12)
    x = rng.randn(2, 64, 144).astype(np.float32)  # fc1 out: 2^16+ elements
    ctx = (0.5 * rng.randn(2, 12, 144)).astype(np.float32)
    t6 = (0.3 * rng.randn(2, 6 * 144)).astype(np.float32)
    pq = PixArtQuantConfig(mx_specs=pixart_mx_specs(), contract="serving",
                           fuse_gelu=True, **PIXART_QKW)
    jq = JaxQuantConfig(mx_specs=jax_specs(), contract="serving",
                        fuse_gelu=True, **PIXART_QKW)

    def port_block(pq):
        calls = record_calls(monkeypatch, stages=())

        def k6(*args, _real=PORT_LINEAR.gelu_quantize_serving, **kwargs):
            out = _real(*args, **kwargs)
            calls.append(("gelu_quantize_serving", args, kwargs, out))
            return out
        monkeypatch.setattr(PORT_LINEAR, "gelu_quantize_serving", k6)
        out = port_pixart.pixart_block_apply(
            model.blocks[0], torch.from_numpy(x), torch.from_numpy(ctx),
            torch.from_numpy(t6), model.cfg, pq.mx_specs,
            pq.self_attn_cfg(0, None), pq.cross_attn_cfg(0, None),
            fuse_gelu=pq.fuse_gelu)
        monkeypatch.undo()
        return out, calls

    _, calls = port_block(dataclasses.replace(pq, contract="exact"))
    assert "gelu_quantize_serving" not in [c[0] for c in calls]
    got, calls = port_block(pq)
    k6 = [c for c in calls if c[0] == "gelu_quantize_serving"]
    assert len(k6) == 1
    pending = [c for c in calls if c[0] != "gelu_quantize_serving"]
    answer_jax(monkeypatch, pending)

    def fused_gelu(h, specs, approximate=True):
        (hp, _), _, out = k6.pop(0)[1:]
        _check(_np(hp), h)
        _assert_grid_tie_parity(_interpret_gelu_serving(
            jnp.asarray(_np(hp)), specs, approximate), _np(out))
        return jnp.asarray(_np(out)).astype(jnp.bfloat16)

    monkeypatch.setattr(jax_pixart, "gelu_quantize_serving", fused_gelu)
    scfg, ccfg = pq.self_attn_cfg(0, None), pq.cross_attn_cfg(0, None)
    want = jax_pixart.pixart_block_apply(
        unstack_block(jparams["blocks"], 0), jnp.asarray(x),
        jnp.asarray(ctx), jnp.asarray(t6), jcfg, jq.mx_specs,
        JaxAttnConfig(**scfg._asdict()), JaxAttnConfig(**ccfg._asdict()),
        fuse_gelu=True)
    monkeypatch.undo()
    assert not pending and not k6, "the port made calls JAX did not"
    _check(_np(got), want)
