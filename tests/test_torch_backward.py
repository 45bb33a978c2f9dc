"""The port's MX linear, matmul and bmm backward (``ops/linear.py``'s
``MxLinear`` / ``MxMatmul``) against ``jax.grad`` of the JAX package's
custom VJPs on the same seeded inputs, on both engines, with
``quantize_backprop`` on and off, and against the reference torch goldens
(tests/golden/backward.npz, at tests/test_backward_golden.py's bounds).

Tolerances.  The backward's quantized operands (each operand MX-quantized
along its own axis) are bit-exact.  The products of grid points are exact
in f32, but torch and XLA add them in other orders, so a gradient may
differ in its last f32 bits: at bfloat 0 (and with the backward
unquantized) within 2e-5 relative and absolute, JAX's golden bound; at
bfloat 16 the half-away bf16 round of each result can turn that into one
bf16 step, so at least 99% of the elements bit-equal and none more than one
bf16 step (2^-7 relative) apart.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mx_quantization_tpu import finalize_mx_specs as jax_finalize
from mx_quantization_tpu.ops.linear import bmm as jax_bmm
from mx_quantization_tpu.ops.linear import linear as jax_linear
from mx_quantization_tpu.ops.linear import matmul as jax_matmul
from mx_quantization_tpu.ops.mx import quantize_mx_op as jax_quantize_mx

from mx_quantization_tpu_torch.ops.linear import bmm, linear, matmul
from mx_quantization_tpu_torch.ops.mx import quantize_mx_op
from mx_quantization_tpu_torch.ops.quantize_ste import (quantize_bfloat_grad,
                                                        quantize_mx_ste)
from mx_quantization_tpu_torch.specs import finalize_mx_specs

GOLD = os.path.join(os.path.dirname(__file__), "golden", "backward.npz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread keeps the module's cost its own
    when the suite runs several processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(engine="ref", bfloat=0, qb=True):
    d = dict(w_elem_format="int8", a_elem_format="int8", scale_bits=8,
             shared_exp_method="max", block_size=32, bfloat=bfloat, fp=0,
             round="nearest", mx_flush_fp32_subnorms=False,
             quantize_backprop=qb, custom_tpu=engine)
    return finalize_mx_specs(d), jax_finalize(d)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(True)


def _close(got, want, bfloat):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if bfloat == 16:
        assert (got == want).mean() >= 0.99
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _torch_grads(fn, args, g):
    out = fn(*args)
    (out * torch.from_numpy(g)).sum().backward()
    return out, [a.grad for a in args]


@pytest.mark.parametrize("engine", ["ref", "fused"])
@pytest.mark.parametrize("qb", [True, False])
@pytest.mark.parametrize("bfloat", [0, 16])
@pytest.mark.parametrize("bias,width", [(True, 64), (False, 64),
                                        (True, 72)])
def test_linear_grads_match_jax(engine, qb, bfloat, bias, width):
    """Width 72: the token-axis and output-axis quantizers pad their last
    block."""
    specs, jspecs = _specs(engine, bfloat, qb)
    x, w = _rand((2, 40, width), 1), _rand((96, width), 2, 0.1)
    b, g = _rand((96,), 3, 0.1), _rand((2, 40, 96), 4)
    args = [x, w] + ([b] if bias else [])

    def jf(*a):
        return jnp.sum(jax_linear(a[0], a[1], a[2] if bias else None,
                                  mx_specs=jspecs) * g)
    want = jax.jit(jax.grad(jf, argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))
    out, got = _torch_grads(
        lambda *a: linear(a[0], a[1], a[2] if bias else None,
                          mx_specs=specs), [_t(a) for a in args], g)
    assert out.grad_fn is not None
    for gt, wt in zip(got, want):
        _close(gt, wt, bfloat if qb else 0)


@pytest.mark.parametrize("axis", [-2, 0, -1])
def test_backward_quantized_operands_bit_exact(axis):
    """The backward's operand quantizes (x and g along the token axis, w
    along its output axis, g along -1), padded tails included."""
    specs, jspecs = _specs()
    x = _rand((2, 40, 72), 5) if axis != 0 else _rand((72, 40), 6)
    want = jax.jit(lambda x: jax_quantize_mx(
        x, jspecs, elem_format="int8", axes=[axis], round="nearest"))(
            jnp.asarray(x))
    got = quantize_mx_op(torch.from_numpy(x), specs, elem_format="int8",
                         axes=[axis], round="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine", ["ref", "fused"])
@pytest.mark.parametrize("qb", [True, False])
@pytest.mark.parametrize("bfloat", [0, 16])
@pytest.mark.parametrize("mode", ["aa", "aw", "wa", "bmm", "broadcast"])
def test_matmul_and_bmm_grads_match_jax(engine, qb, bfloat, mode):
    """matmul in each mode, bmm, and a 2-D b against a batched a (its
    gradient summed over the broadcast batch axes)."""
    specs, jspecs = _specs(engine, bfloat, qb)
    a = _rand((2, 3, 16, 64), 7)
    b = _rand((64, 32), 8) if mode == "broadcast" else _rand((2, 3, 64, 32),
                                                             8)
    g = _rand((2, 3, 16, 32), 9)
    if mode == "bmm":
        jfn = lambda a, b: jax_bmm(a, b, mx_specs=jspecs)  # noqa: E731
        tfn = lambda a, b: bmm(a, b, mx_specs=specs)  # noqa: E731
    else:
        mc = "aa" if mode == "broadcast" else mode
        jfn = lambda a, b: jax_matmul(a, b, mx_specs=jspecs,  # noqa: E731
                                      mode_config=mc)
        tfn = lambda a, b: matmul(a, b, mx_specs=specs,  # noqa: E731
                                  mode_config=mc)
    want = jax.jit(jax.grad(lambda a, b: jnp.sum(jfn(a, b) * g),
                           argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    _, got = _torch_grads(tfn, [_t(a), _t(b)], g)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        _close(gt, wt, bfloat if qb else 0)


@pytest.mark.parametrize("op,needed", [("linear", 0), ("linear", 1),
                                       ("matmul", 0), ("matmul", 1)])
def test_unneeded_gradients_are_skipped(monkeypatch, op, needed):
    """With one operand alone requiring grad, its gradient is the one it
    gets when both do, and the backward quantizes only the two operands
    that gradient takes (as JAX under jit drops an unused cotangent)."""
    import importlib
    linear_mod = importlib.import_module(
        "mx_quantization_tpu_torch.ops.linear")
    specs, _ = _specs("ref", 0, True)
    if op == "linear":
        a, b = _rand((2, 40, 64), 17), _rand((96, 64), 18, 0.1)
        g = _rand((2, 40, 96), 19)
        fn = lambda a, b: linear(a, b, mx_specs=specs)  # noqa: E731
    else:
        a, b, g = (_rand((2, 3, 16, 64), 17), _rand((2, 3, 64, 32), 18),
                   _rand((2, 3, 16, 32), 19))
        fn = lambda a, b: matmul(a, b, mx_specs=specs)  # noqa: E731
    _, both = _torch_grads(fn, [_t(a), _t(b)], g)
    args = [torch.from_numpy(a), torch.from_numpy(b)]
    args[needed].requires_grad_(True)
    out = fn(*args)
    calls = []
    real = linear_mod.quantize_mx_op
    monkeypatch.setattr(linear_mod, "quantize_mx_op",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    (out * torch.from_numpy(g)).sum().backward()
    assert args[1 - needed].grad is None and len(calls) == 2
    assert torch.equal(args[needed].grad, both[needed])


def test_unquantized_linear_keeps_full_f32_autograd():
    x, w, b, g = (_rand((4, 24), 10), _rand((8, 24), 11), _rand((8,), 12),
                  _rand((4, 8), 13))
    want = jax.grad(lambda x, w, b: jnp.sum(jax_linear(x, w, b) * g),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    _, got = _torch_grads(lambda x, w, b: linear(x, w, b),
                          [_t(x), _t(w), _t(b)], g)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-6,
                                   atol=1e-6)


def test_no_autograd_forward_is_the_recorded_forward():
    """The forward without autograd and the recorded one are the same
    values (the Function only adds the backward)."""
    specs, _ = _specs("fused", 16)
    x, w, b = _rand((2, 8, 64), 14), _rand((32, 64), 15), _rand((32,), 16)
    with torch.no_grad():
        plain = linear(*map(torch.from_numpy, (x, w, b)), mx_specs=specs)
    rec = linear(_t(x), _t(w), _t(b), mx_specs=specs)
    assert plain.grad_fn is None and rec.grad_fn is not None
    assert torch.equal(plain, rec.detach())


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLD)


@pytest.mark.parametrize("tag,bfloat,bias", [
    ("lin32", 0, True), ("lin72", 0, True), ("lin_bf16", 16, True),
    ("lin_nobias", 0, False)])
def test_linear_backward_golden(golden, tag, bfloat, bias):
    specs, _ = _specs(bfloat=bfloat)
    args = [golden[f"{tag}_x"], golden[f"{tag}_w"]] + \
        ([golden[f"{tag}_b"]] if bias else [])
    out, got = _torch_grads(
        lambda *a: linear(a[0], a[1], a[2] if bias else None,
                          mx_specs=specs), [_t(a) for a in args],
        golden[f"{tag}_g"])
    np.testing.assert_allclose(out.detach().numpy(), golden[f"{tag}_out"],
                               rtol=2e-5, atol=2e-5)
    for gt, key in zip(got, ("gx", "gw", "gb")):
        np.testing.assert_allclose(gt.numpy(), golden[f"{tag}_{key}"],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["aa", "aw", "wa", "bmm"])
def test_matmul_backward_golden(golden, mode):
    specs, _ = _specs()
    pre = "bmm" if mode == "bmm" else f"mm_{mode}"
    fn = (lambda a, b: bmm(a, b, mx_specs=specs)) if mode == "bmm" else \
        (lambda a, b: matmul(a, b, mx_specs=specs, mode_config=mode))
    out, (ga, gb) = _torch_grads(fn, [_t(golden[f"{pre}_a"]),
                                      _t(golden[f"{pre}_b"])],
                                 golden[f"{pre}_g"])
    np.testing.assert_allclose(out.detach().numpy(), golden[f"{pre}_out"],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ga.numpy(), golden[f"{pre}_ga"], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(gb.numpy(), golden[f"{pre}_gb"], rtol=2e-5,
                               atol=2e-5)


def test_quantize_ste_wrappers_match_jax():
    from mx_quantization_tpu.ops.quantize_ste import \
        quantize_bfloat_grad as jax_qbg
    from mx_quantization_tpu.ops.quantize_ste import \
        quantize_mx_ste as jax_qms
    specs, jspecs = _specs(bfloat=16)
    x, g = _rand((4, 64), 17), _rand((4, 64), 18)
    for tfn, jfn in ((lambda x: quantize_bfloat_grad(x, specs),
                      lambda x: jax_qbg(x, jspecs)),
                     (lambda x: quantize_mx_ste(x, specs, "int8", -1),
                      lambda x: jax_qms(x, jspecs, "int8", -1))):
        xt = _t(x)
        out = tfn(xt)
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_array_equal(
            out.detach().numpy(), np.asarray(jax.jit(jfn)(jnp.asarray(x))))
        want = jax.jit(jax.grad(lambda x: jnp.sum(jfn(x) * g)))(
            jnp.asarray(x))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
