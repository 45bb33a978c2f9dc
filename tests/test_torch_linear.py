"""The port's MX linear (forward) and weight pre-quantization against the
JAX package, at the DiT operating point (MXINT8, block 32, bfloat=16).

Tolerance of the quantized linear: the activation and weight grids are
bit-exact, and every product of two grid points is exact in f32, but the
f32 sums add in another order in torch than in XLA.  Where a partial sum
needs more than 24 bits the two can differ in the last f32 bit, and the
half-away bf16 round of the output turns that into one bf16 step when the
value sits next to a rounding boundary.  So: at least 99% of the outputs
bit-equal, and none more than one bf16 step (2^-7 relative) apart.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.ops.linear import linear as jax_linear
from mx_quantization_tpu.utils.prequantize import \
    prequantize_weights as jax_prequantize
from mx_quantization_tpu.workloads.dit import dit_mx_specs as jax_specs

from mx_quantization_tpu_torch.models.dit import DiTConfig, init_dit
from mx_quantization_tpu_torch.ops.linear import linear, mm_f32
from mx_quantization_tpu_torch.utils.prequantize import prequantize_weights
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs


def _rand(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return (scale * rng.randn(*shape)).astype(np.float32)


def _assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert (got == want).mean() >= 0.99
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax_with_prequantized_bf16_weights(act, bias):
    x = _rand((2, 16, 288), 1)
    w = _rand((96, 288), 2, 0.05)
    b = _rand((96,), 3, 0.1) if bias else None
    jp, jspecs = jax_prequantize({"qkv": {"weight": jnp.asarray(w)}},
                                 jax_specs(), serve_dtype=jnp.bfloat16)
    want = jax_linear(jnp.asarray(x).astype(act), jp["qkv"]["weight"],
                      None if b is None else jnp.asarray(b),
                      mx_specs=jspecs)

    specs = dit_mx_specs().replace(prequantized_weights=True)
    wq = torch.from_numpy(np.asarray(jp["qkv"]["weight"], np.float32)
                          ).to(torch.bfloat16)
    got = linear(torch.from_numpy(x).to(getattr(torch, act)), wq,
                 None if b is None else torch.from_numpy(b), mx_specs=specs)
    assert got.dtype == torch.float32
    _assert_bf16_close(got.numpy(), want)


def test_linear_quantizes_weights_on_the_fly_like_jax():
    x, w, b = _rand((8, 64), 4), _rand((32, 64), 5), _rand((32,), 6)
    want = jax_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      mx_specs=jax_specs())
    got = linear(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(b), mx_specs=dit_mx_specs())
    _assert_bf16_close(got.numpy(), want)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16")])
def test_unquantized_linear_matches_jax(dtypes):
    """mx_specs=None: full f32 product, JAX's output dtype."""
    xd, wd = dtypes
    x, w, b = _rand((8, 64), 7), _rand((32, 64), 8), _rand((32,), 9)
    want = jax_linear(jnp.asarray(x).astype(xd), jnp.asarray(w).astype(wd))
    got = linear(torch.from_numpy(x).to(getattr(torch, xd)),
                 torch.from_numpy(w).to(getattr(torch, wd)))
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-5 if want.dtype == jnp.float32
                               else 2.0 ** -8, atol=1e-5)
    got_b = linear(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b))
    want_b = jax_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=1e-5, atol=1e-5)


def test_bf16_product_with_f32_result_on_cpu():
    a = torch.from_numpy(_rand((4, 5, 32), 10)).to(torch.bfloat16)
    b = torch.from_numpy(_rand((6, 32), 11)).to(torch.bfloat16)
    out = mm_f32(a, b)
    assert out.dtype == torch.float32 and out.shape == (4, 5, 6)
    want = a.double() @ b.double().t()
    torch.testing.assert_close(out.double(), want, rtol=1e-6, atol=1e-6)


def test_prequantize_matches_jax_and_spares_block_adaln():
    cfg = DiTConfig(input_size=4, hidden_size=64, depth=1, num_heads=2,
                    num_classes=4)
    model = init_dit(cfg, torch.Generator().manual_seed(0), "cpu",
                     randomize_all=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model, specs = prequantize_weights(model, dit_mx_specs(),
                                       serve_dtype=torch.bfloat16)
    assert specs.prequantized_weights
    params = dict(model.named_parameters())
    # block adaLN: unquantized, only cast to bf16; final adaLN: quantized
    assert torch.equal(params["blocks.0.adaLN.weight"],
                       before["blocks.0.adaLN.weight"].to(torch.bfloat16))
    assert params["blocks.0.attn.qkv.bias"].dtype == torch.float32
    for name in ("blocks.0.attn.qkv.weight", "blocks.0.mlp.fc2.weight",
                 "final_layer.adaLN.weight", "final_layer.linear.weight"):
        # the same path in a JAX tree (the stacked tree has no block index)
        keys = [k for k in name.split(".") if not k.isdigit()]
        tree = leaf = {}
        for key in keys[:-1]:
            leaf[key] = {}
            leaf = leaf[key]
        leaf["weight"] = jnp.asarray(before[name].numpy())
        jp, _ = jax_prequantize(tree, jax_specs(), serve_dtype=jnp.bfloat16)
        for key in keys:
            jp = jp[key]
        assert params[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(params[name].float().numpy(),
                                      np.asarray(jp, np.float32))
