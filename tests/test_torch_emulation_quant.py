"""The emulation engine's quantizers (``ops/{bitmath,elemwise,mx}.py`` of the
port) against the reference-torch goldens and against the JAX package.

* Goldens (``tests/golden/{elemwise,mx}.npz``, made by the reference's own
  torch quantizer): every key of the five families of
  tests/test_quantize_parity.py (``elem_``, ``bfloat_``, ``fp_``, ``mx_``,
  ``mxnone_``), grouped per format as cases of one test, under that file's
  rule: equal values with the same NaN mask.  (In the flush mode,
  ``allow_denorm=False``, JAX and the port both give -0.0 where the golden
  holds +0.0; the value rule counts them equal, as JAX's test does.)
* JAX: bit for bit (the int32 patterns, NaN mask aside) on inputs with
  subnormals, +-0, +-Inf, NaN, all-zero and subnormal-max blocks: the
  elementwise quantizers at every element format, the three round modes,
  saturation and flush and the predict-phase flag; the bit primitives; the
  shared exponents; the spec-driven ops; and the packed ``mx_encode`` /
  ``mx_decode``.  ``mx_decode`` is a float multiply, and XLA's CPU flushes
  its subnormal products to zero where torch keeps them: there the port's
  subnormal must be JAX's signed zero.  The block quantizer against JAX is
  tests/test_torch_emulation_quant_mx.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.ops import bitmath as jax_bitmath
from mx_quantization_tpu.ops import elemwise as jax_elemwise
from mx_quantization_tpu.ops import mx as jax_mx

from mx_quantization_tpu_torch.ops import bitmath, elemwise, mx
from mx_quantization_tpu_torch.specs import finalize_mx_specs
from emulation_goldens import (ELEM_FORMATS, MX_FORMATS, check_all,
                               golden_cases, golden_mismatches, load)

ELEM, MX = load()
# (family, format) of every golden key: the cases of test_golden
GOLDEN_GROUPS = sorted({(fam, fmt) for fam, fmt, *_ in golden_cases(ELEM,
                                                                     MX)})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only contends with the other test
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_golden_equal(got, want, msg=""):
    """tests/test_quantize_parity.py's rule: the same NaN mask, equal
    values elsewhere."""
    assert not golden_mismatches(got, want), msg


def assert_bits_equal(got, want, msg=""):
    """The same NaN mask and the same float32 bit patterns elsewhere."""
    got = np.ascontiguousarray(np.asarray(got, np.float32))
    want = np.ascontiguousarray(np.asarray(want, np.float32))
    assert got.shape == want.shape, msg
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    assert (nan_g == nan_w).all(), f"NaN mismatch {msg}"
    g, w = got.view(np.uint32)[~nan_g], want.view(np.uint32)[~nan_w]
    bad = g != w
    if bad.any():
        raise AssertionError(
            f"{bad.sum()} bit mismatches {msg}: got "
            f"{g[bad][:4].view(np.float32)} want {w[bad][:4].view(np.float32)}")


def assert_bits_equal_ftz(got, want, msg=""):
    """``assert_bits_equal`` for a float-arithmetic result that XLA's CPU
    flushes: the port's subnormals compared as signed zeros."""
    got = np.array(got, np.float32)
    tiny = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    got[tiny] = np.copysign(0.0, got[tiny])
    assert_bits_equal(got, want, msg)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("family,fmt", GOLDEN_GROUPS)
def test_golden(family, fmt):
    """Every golden key of one family and format."""
    n, bad = check_all(ELEM, MX, "cpu", family, fmt)
    assert n and not bad, bad


def special_input(rows=6, cols=70, seed=0):
    """Normal values over a wide exponent range, with subnormals, +-0,
    +-Inf and NaN, an all-zero block and a block whose max is subnormal;
    70 columns leave a ragged tail at every block size."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, cols) *
         2.0 ** rng.randint(-20, 20, (rows, cols))).astype(np.float32)
    x[0, :8] = [1e-40, -3e-42, 1.4e-45, -1.4e-45, 0.0, -0.0, 1.1754942e-38,
                -1.1754942e-38]
    x[1, :32] = 0.0
    x[2, :32] = rng.randn(32).astype(np.float32) * 1e-39
    x[3, :4] = [np.inf, -np.inf, 3e38, -3e38]
    x[4, 40] = np.nan
    x[5, :] = rng.randn(cols).astype(np.float32) * 1e-3
    x[5, 3] = 2.0 ** -133  # a subnormal among small normals
    return x


@pytest.mark.parametrize("fmt", ELEM_FORMATS)
def test_elemwise_matches_jax_on_special_inputs(fmt):
    x = special_input(seed=1)
    for rnd in ("nearest", "floor", "even"):
        for sat, denorm in ((True, True), (False, False), (False, True)):
            for flag in (False, True):
                kw = dict(round=rnd, saturate_normals=sat,
                          allow_denorm=denorm, predict_phase=flag)
                got = elemwise.quantize_elemwise(_t(x), fmt, **kw)
                want = jax_elemwise.quantize_elemwise(jnp.asarray(x), fmt,
                                                      **kw)
                assert got.dtype == torch.float32
                assert_bits_equal(got, want, f"{fmt} {kw}")


def test_bitmath_matches_jax():
    x = special_input(seed=3).reshape(-1)
    e = np.random.RandomState(4).randint(-300, 300, x.shape).astype(np.int32)
    e[:20] = [-149, -150, -126, -127, 127, 128, -1, 1, 0, 200, -200, 23, -23,
              150, -152, 254, -254, 5, -5, 2]
    assert_bits_equal(bitmath.scalbn(_t(x), _t(e)),
                      jax_bitmath.scalbn(jnp.asarray(x), jnp.asarray(e)))
    np.testing.assert_array_equal(
        bitmath.floor_log2_int(_t(x)).numpy(),
        np.asarray(jax_bitmath.floor_log2_int(jnp.asarray(x))))
    xs = x.reshape(-1, 14)
    for axis in (0, -1, [0, 1]):
        np.testing.assert_array_equal(
            bitmath.max_abs_bits(_t(xs), axis).numpy(),
            np.asarray(jax_bitmath.max_abs_bits(jnp.asarray(xs), axis)))
    b = bitmath.max_abs_bits(_t(xs), -1)
    np.testing.assert_array_equal(
        bitmath.bits_floor_log2(b).numpy(),
        np.asarray(jax_bitmath.bits_floor_log2(jnp.asarray(b.numpy()))))
    assert_bits_equal(elemwise.pow2(_t(e[:20])),
                      jax_elemwise.pow2(jnp.asarray(e[:20])))


def test_shared_exponents_and_pow2_f_match_jax():
    x = special_input(seed=5)
    blk, _ = mx.block_view(_t(x), -1, 32)
    jblk, _ = jax_mx.block_view(jnp.asarray(x), -1, 32)
    for method in ("max", "none"):
        for ebits in (0, 4, 8):
            got = mx.shared_exponents(blk, method, axes=[-1], ebits=ebits)
            want = jax_mx.shared_exponents(jblk, method, axes=[-1],
                                           ebits=ebits)
            assert_bits_equal(got, want, f"{method} {ebits}")
            assert_bits_equal(mx.pow2_f(got), jax_mx.pow2_f(want))


def test_spec_driven_ops_match_jax():
    x = special_input(seed=6)
    for kw in (dict(bfloat=16), dict(bfloat=16, round="even"),
               dict(bfloat=12, round="floor"), dict(fp=8), dict(bfloat=32),
               dict(bfloat=16, round="even", bfloat_subnorms=False)):
        specs = finalize_mx_specs(dict(a_elem_format="int8", block_size=32,
                                       **kw))
        from mx_quantization_tpu.specs import finalize_mx_specs as jax_fin
        jspecs = jax_fin(dict(a_elem_format="int8", block_size=32, **kw))
        got = elemwise.quantize_elemwise_op(_t(x), specs)
        want = jax_elemwise.quantize_elemwise_op(jnp.asarray(x), jspecs)
        assert_bits_equal(got, want, str(kw))
        got = mx.quantize_mx_op(got, specs, "int8", axes=[-1],
                                round=specs.round_mx_output)
        want = jax_mx.quantize_mx_op(want, jspecs, "int8", axes=[-1],
                                     round=jspecs.round_mx_output)
        assert_bits_equal(got, want, str(kw))
    # a bf16 input: the RNE round trip keeps bf16, the others give f32
    xb = _t(x).to(torch.bfloat16)
    specs = finalize_mx_specs(dict(bfloat=16, round="even"))
    assert elemwise.quantize_elemwise_op(xb, specs).dtype == torch.bfloat16
    specs = finalize_mx_specs(dict(bfloat=16))
    assert elemwise.quantize_elemwise_op(xb, specs).dtype == torch.float32


def test_sparse_input_quantizes_values_and_keeps_indices():
    specs = finalize_mx_specs(dict(bfloat=12, round="nearest"))
    dense = torch.zeros(4, 6)
    dense[0, 1], dense[2, 5], dense[3, 0] = 1.2345, -7.654321, 3e-3
    got = elemwise.quantize_elemwise_op(dense.to_sparse(), specs)
    assert got.layout == torch.sparse_coo
    torch.testing.assert_close(got.to_dense(),
                               elemwise.quantize_elemwise_op(dense, specs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["int8", "int4", "int2"])
def test_mx_encode_decode_match_jax(fmt):
    x = special_input(seed=7)
    x[~np.isfinite(x)] = 1.0
    x[0, 40:48] = 3e38  # an overflowed block at scale_bits 5: NaN sentinel
    for sb, flush in ((8, False), (5, True)):
        p = mx.mx_encode(_t(x), fmt, 32, scale_bits=sb,
                         flush_fp32_subnorms=flush)
        jp = jax_mx.mx_encode(jnp.asarray(x), fmt, 32, scale_bits=sb,
                              flush_fp32_subnorms=flush)
        np.testing.assert_array_equal(p.mantissa.numpy(),
                                      np.asarray(jp.mantissa))
        np.testing.assert_array_equal(p.exp.numpy(), np.asarray(jp.exp))
        assert (p.orig_len, p.elem_format, p.block_size) == \
            (jp.orig_len, jp.elem_format, jp.block_size)
        assert_bits_equal_ftz(mx.mx_decode(p), jax_mx.mx_decode(jp))
        if sb == 5:
            # decoding gives the fake-quantized values, overflowed blocks as
            # NaN (at scale_bits 8 a block exponent of 127 is the sentinel)
            want = mx.quantize_mx(_t(x), sb, fmt, axes=[-1], block_size=32,
                                  flush_fp32_subnorms=flush)
            assert_golden_equal(mx.mx_decode(p), want)
