"""The emulation engine's MX block quantizer (``ops/mx.py`` ``quantize_mx``
of the port) against the JAX package's, bit for bit (the int32 patterns,
NaN mask aside), at every element format on inputs with subnormals, +-0,
+-Inf, NaN, all-zero and subnormal-max blocks and a ragged tail: blocks of
32 and 64 along the last axis and of 16 along axis 0, scale_bits 5 and 8,
flush on and off, the three round modes, the predict-phase flag and the
"none" shared-exponent method.  (Each new shape costs JAX's eager dispatch
a few seconds of compilation, so the shapes are few; the goldens hold
block sizes 9, 16 and 32 on both axes, tests/test_torch_emulation_quant.py.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.ops import mx as jax_mx

from mx_quantization_tpu_torch.ops import mx
from test_torch_emulation_quant import (MX_FORMATS, _one_torch_thread,  # noqa: F401
                                        _t, assert_bits_equal, special_input)


@pytest.mark.parametrize("fmt", MX_FORMATS)
def test_mx_matches_jax_on_special_inputs(fmt):
    x = special_input(seed=2)
    rounds = ("nearest", "floor", "even")
    i = 0
    for axis, bs in ((-1, 32), (-1, 64), (0, 16)):
        for sb in (5, 8):
            for flush in (False, True):
                kw = dict(axes=[axis], block_size=bs, round=rounds[i % 3],
                          flush_fp32_subnorms=flush,
                          predict_phase=i % 4 == 0)
                i += 1
                got = mx.quantize_mx(_t(x), sb, fmt, **kw)
                want = jax_mx.quantize_mx(jnp.asarray(x), sb, fmt, **kw)
                assert_bits_equal(got, want, f"{fmt} sb={sb} {kw}")
    # the "none" method: every element its own exponent
    kw = dict(axes=[-1], block_size=32, shared_exp_method="none")
    assert_bits_equal(mx.quantize_mx(_t(x), 8, fmt, **kw),
                      jax_mx.quantize_mx(jnp.asarray(x), 8, fmt, **kw), fmt)
