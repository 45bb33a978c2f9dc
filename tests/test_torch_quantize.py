"""The port's MX quantizers (K1's plain version, the float-domain fast path)
against the JAX package, bit for bit on normal-range inputs.

The JAX Pallas kernel ``mx_quantize_pallas`` runs in interpret mode on the
CPU.  Inputs come from numpy with a seed, with rows scaled across a wide
exponent range so that the blocks' shared exponents differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.ops.fastquant import \
    bf16_round_half_away as jax_bf16_round
from mx_quantization_tpu.ops.fastquant import quantize_mx_fast as jax_fast
from mx_quantization_tpu.ops.fastquant import \
    quantize_mx_serving as jax_serving
from mx_quantization_tpu.formats import ElemFormat as JaxElemFormat
from mx_quantization_tpu.formats import format_params as jax_format_params
from mx_quantization_tpu.ops.kernels.quantize import mx_quantize_pallas
from mx_quantization_tpu.workloads.dit import dit_mx_specs as jax_dit_specs

from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.ops.fastquant import (bf16_round_half_away,
                                                     quantize_mx_fast,
                                                     quantize_mx_serving)
from mx_quantization_tpu_torch.ops.kernels.quantize import (mx_quantize,
                                                            mx_quantize_ref)
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    # spread the block exponents: each row gets its own power-of-two scale
    return x * np.exp2(rng.randint(-20, 20, size=shape[:-1] + (1,))
                       ).astype(np.float32)


def _np(t):
    return np.asarray(t, dtype=np.float32)


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8_e4m3"])
@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("bfloat", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_matches_pallas(fmt, flush, bfloat, dtype):
    x = _inputs((48, 128), seed=1)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = mx_quantize_pallas(xj, elem_format=fmt, block_size=32,
                              scale_bits=8, flush=flush, bfloat=bfloat)
    got = mx_quantize_ref(xt, fmt, 32, 8, flush=flush, bfloat=bfloat)
    np.testing.assert_array_equal(_np(got.float()), _np(want))
    # the wrapper takes the plain version for a CPU tensor
    got_w = mx_quantize(xt, fmt, 32, 8, flush=flush, bfloat=bfloat)
    assert torch.equal(got_w, got)


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8_e4m3"])
@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("axis,shape", [(-1, (16, 96)), (0, (40, 24))])
def test_quantize_mx_fast_matches_jax(fmt, flush, axis, shape):
    """Any axis, including a ragged tail that pads the last block."""
    x = _inputs(shape, seed=2)
    want = jax_fast(jnp.asarray(x), fmt, 32, 8, axis=axis, flush=flush)
    got = quantize_mx_fast(torch.from_numpy(x), fmt, 32, 8, axis=axis,
                           flush=flush)
    np.testing.assert_array_equal(_np(got.float()), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bfloat", [0, 16])
def test_quantize_mx_serving_matches_jax(dtype, bfloat):
    """bf16 inputs at bfloat=16 take the skipped-round branch."""
    x = _inputs((8, 4, 64), seed=3)
    want = jax_serving(jnp.asarray(x).astype(dtype), "int8", 32, 8,
                       bfloat=bfloat)
    got = quantize_mx_serving(torch.from_numpy(x).to(getattr(torch, dtype)),
                              "int8", 32, 8, bfloat=bfloat)
    np.testing.assert_array_equal(_np(got.float()), _np(want))


def test_bf16_round_half_away_matches_jax_on_ties():
    rng = np.random.RandomState(4)
    bits = rng.randint(0, 2 ** 31 - 1, size=4096).astype(np.uint32)
    bits[:2048] = (bits[:2048] & 0xFFFF0000) | 0x8000  # exact ties
    bits[::3] |= np.uint32(0x80000000)  # negatives
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    want = _np(jax_bf16_round(jnp.asarray(x)))
    got = bf16_round_half_away(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # and it is not the round-half-to-even cast on the ties
    rne = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert (rne != got).any()


def test_kernel_wrappers_never_take_the_plain_path_off_cpu():
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError):
        mx_quantize(x)
    # a non-last axis takes the plain chain on any device, as JAX takes its
    # XLA ops there: it never reaches the kernel wrapper
    before = mx_quantize.launches
    out = quantize_mx_serving(torch.empty(40, 4, device="meta"), "int8", 32,
                              axis=0)
    assert out.shape == (40, 4) and mx_quantize.launches == before


def test_formats_and_specs_are_copies_of_jax():
    for fmt in JaxElemFormat:
        assert format_params(fmt.name) == jax_format_params(fmt)
    want, got = jax_dit_specs(), dit_mx_specs()
    assert got.to_dict() == want.to_dict()  # same knobs, same values
    assert got.backwards().to_dict() == want.backwards().to_dict()
    assert got.json() == want.json()
