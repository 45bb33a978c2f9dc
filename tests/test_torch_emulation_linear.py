"""The emulation engine's linear, matmul and bmm (``ops/linear.py`` of the
port, ``custom_tpu="ref"``) against the JAX package's ref engine, and the
port's fast path against its own emulation.

Tolerances: the MX operands are bit-exact (tests/test_torch_emulation_
quant.py) and every product of two grid points is exact in f32, but the f32
sums add in another order in torch than in XLA.  With no elementwise format
the outputs agree to f32 rounding of the sums (rtol 1e-5); with bfloat=16
or fp=16 the output's half-away round turns a last-bit difference next to a
rounding boundary into one step of that grid, so at least 99% of the
outputs are bit-equal and none is more than one step (2^-7 for bfloat16,
2^-10 for fp16) apart.  The port's fast path against its emulation is held
to JAX's own bound for the same check (tests/test_fastpath.py:56-70: rtol
1e-6, atol 1e-6).

The JAX calls share a few shapes (X, W, B below): JAX's eager dispatch
compiles its ops anew for each shape, at a few seconds each.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.ops.linear import bmm as jax_bmm
from mx_quantization_tpu.ops.linear import linear as jax_linear
from mx_quantization_tpu.ops.linear import matmul as jax_matmul
from mx_quantization_tpu.specs import finalize_mx_specs as jax_finalize
from mx_quantization_tpu.utils.prequantize import \
    prequantize_weights as jax_prequantize

from mx_quantization_tpu_torch.ops.fastquant import quantize_mx_serving
from mx_quantization_tpu_torch.ops.kernels.quantize import mx_quantize
from mx_quantization_tpu_torch.ops.linear import bmm, linear, matmul
from mx_quantization_tpu_torch.specs import MxSpecs, finalize_mx_specs
from mx_quantization_tpu_torch.utils.prequantize import prequantize_weights
from test_torch_emulation_quant import _one_torch_thread  # noqa: F401

FORMATS = ("int8", "int4", "fp8_e4m3", "fp6_e2m3", "fp4")
ELEMWISE = (dict(bfloat=0), dict(bfloat=16), dict(fp=16))


def _specs(fmt, engine="ref", **kw):
    d = dict(w_elem_format=fmt, a_elem_format=fmt, scale_bits=8,
             block_size=32, quantize_backprop=False, custom_tpu=engine, **kw)
    return finalize_mx_specs(dict(d)), jax_finalize(dict(d))


def _rand(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return (scale * rng.randn(*shape)).astype(np.float32)


# an 80-wide contraction: two whole blocks and a ragged one
X, W, BIAS = _rand((2, 8, 80), 1, 2.0), _rand((24, 80), 2, 0.1), \
    _rand((24,), 3)
B = _rand((2, 80, 24), 5)


def assert_matches_jax(got, want, elem):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if elem.get("bfloat", 0) not in (0, 32) or elem.get("fp", 0):
        # one step of the output grid: 2^-(mantissa bits)
        bits = elem["bfloat"] - 9 if elem.get("bfloat") else elem["fp"] - 6
        step = 2.0 ** -bits
        assert (got == want).mean() >= 0.99
        np.testing.assert_allclose(got, want, rtol=step, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("elem", ELEMWISE, ids=["b0", "b16", "fp16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_ref_linear_matches_jax(fmt, elem):
    specs, jspecs = _specs(fmt, **elem)
    x, w = X, W
    for bias in (None, BIAS):
        got = linear(torch.from_numpy(x), torch.from_numpy(w),
                     None if bias is None else torch.from_numpy(bias),
                     mx_specs=specs)
        want = jax_linear(jnp.asarray(x), jnp.asarray(w),
                          None if bias is None else jnp.asarray(bias),
                          mx_specs=jspecs)
        assert got.dtype == torch.float32
        assert_matches_jax(got, want, elem)


@pytest.mark.parametrize("fmts", [("int8", "int8"), ("fp8_e4m3", "int4"),
                                  ("fp6_e2m3", "fp4")])
def test_ref_matmul_modes_and_bmm_match_jax(fmts):
    """matmul in each mode_config (operand a along -1 and b along -2, each
    in the format the mode names), with a bias; and bmm."""
    afmt, wfmt = fmts
    for elem in ELEMWISE:
        d = dict(w_elem_format=wfmt, a_elem_format=afmt, scale_bits=8,
                 block_size=32, quantize_backprop=False, **elem)
        specs, jspecs = finalize_mx_specs(dict(d)), jax_finalize(dict(d))
        a, b, bias = X, B, BIAS
        for mode in ("aa", "aw", "wa"):
            got = matmul(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(bias), mx_specs=specs,
                         mode_config=mode)
            want = jax_matmul(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(bias), mx_specs=jspecs,
                              mode_config=mode)
            assert_matches_jax(got, want, elem)
        assert_matches_jax(
            bmm(torch.from_numpy(a), torch.from_numpy(b), mx_specs=specs),
            jax_bmm(jnp.asarray(a), jnp.asarray(b), mx_specs=jspecs), elem)
    # unquantized: full f32, JAX's dtype
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_fused_equals_ref(fmt):
    """tests/test_fastpath.py's fused-vs-ref checks on the port's engines."""
    fused, _ = _specs(fmt, engine="fused")
    ref, _ = _specs(fmt)
    x, w, b = _rand((16, 64), 4), _rand((32, 64), 5), _rand((32,), 6)
    torch.testing.assert_close(
        linear(*map(torch.from_numpy, (x, w, b)), mx_specs=fused),
        linear(*map(torch.from_numpy, (x, w, b)), mx_specs=ref),
        rtol=1e-6, atol=1e-6)
    a, bb = _rand((2, 3, 16, 64), 7), _rand((2, 3, 64, 16), 8)
    torch.testing.assert_close(
        matmul(torch.from_numpy(a), torch.from_numpy(bb), mx_specs=fused),
        matmul(torch.from_numpy(a), torch.from_numpy(bb), mx_specs=ref),
        rtol=1e-6, atol=1e-6)


def test_fused_engine_falls_back_to_the_emulation_like_jax():
    """Specs outside the fast path (fp != 0, the "none" shared-exponent
    method, a non-nearest MX round, a non-kernel format) run the emulation
    on the fused engine, as JAX's ``_linear_fwd`` does."""
    x, w = X, W
    for kw in (dict(fp=16), dict(shared_exp_method="none"),
               dict(round_mx_output="even"), dict(bfloat=12)):
        specs, jspecs = _specs("int8", engine="fused", **kw)
        got = linear(torch.from_numpy(x), torch.from_numpy(w), mx_specs=specs)
        want = jax_linear(jnp.asarray(x), jnp.asarray(w), mx_specs=jspecs)
        ref = linear(torch.from_numpy(x), torch.from_numpy(w),
                     mx_specs=specs.replace(custom_tpu="ref"))
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        assert_matches_jax(got, want, kw)


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine"):
        MxSpecs(custom_tpu="pallas")


def test_quantize_along_a_non_last_or_ragged_axis_takes_the_plain_chain():
    """JAX's gate: K1 only along a last axis of whole blocks; elsewhere the
    plain chain, which runs on a tensor of any device (here the meta device
    stands for the card: the kernel wrapper refuses it)."""
    x = torch.empty(40, 4, device="meta")
    assert quantize_mx_serving(x, "int8", 32, axis=0).shape == (40, 4)
    assert quantize_mx_serving(torch.empty(4, 40, device="meta"), "int8",
                               32).shape == (4, 40)
    with pytest.raises(ValueError):
        mx_quantize(torch.empty(4, 64, device="meta"))


@pytest.mark.parametrize("fmt", ["int8", "fp6_e2m3"])
def test_ref_prequantize_matches_jax(fmt):
    """The ref branch: ``quantize_mx`` at the specs' method and round (no
    bfloat round first), as JAX's ``prequantize_weights``."""
    specs, jspecs = _specs(fmt, bfloat=16)
    model = torch.nn.Module()
    model.fc1 = torch.nn.Linear(80, 24)
    model.adaln_single = torch.nn.Module()
    model.adaln_single.linear = torch.nn.Linear(80, 24)  # left unquantized
    with torch.no_grad():
        model.fc1.weight.copy_(torch.from_numpy(W))
        model.adaln_single.linear.weight.copy_(torch.from_numpy(W))
    model, pspecs = prequantize_weights(model, specs)
    assert pspecs.prequantized_weights and pspecs.custom_tpu == "ref"
    jp, _ = jax_prequantize({"fc1": {"weight": jnp.asarray(W)}}, jspecs)
    np.testing.assert_array_equal(model.fc1.weight.detach().numpy(),
                                  np.asarray(jp["fc1"]["weight"]))
    assert torch.equal(model.adaln_single.linear.weight, torch.from_numpy(W))
