"""DeiT quantization-aware training on the port against the JAX package,
at depth 2 on the CPU, and the DeiT losses:

* two training steps (``make_train_step``: the label-smoothed loss's
  ``loss.backward()`` through ``vit_forward``, AdamW at weight decay 0.05
  on the cosine schedule, the EMA at 0.99996) against JAX's ``train`` step
  taken apart (``jax.value_and_grad`` of ``label_smoothing_ce`` over its
  ``vit_forward``, ``optax.adamw(optax.cosine_decay_schedule(lr, 2),
  weight_decay=0.05)``'s updates, the EMA) on the same parameters
  (``vit_params_from_jax`` of JAX's ``init_vit``) and batches: the losses,
  every gradient, every updated parameter and EMA entry.  The plan is
  DeiT's specs with ``quantize_backprop=True`` on the fused engine, top-k
  ex_pred (K2's plain version, the surrogate backward), the last block
  dense;
* ``label_smoothing_ce``, ``soft_kl`` and ``distillation_loss`` (none,
  soft, hard, and a (cls, dist) pair) within 1e-6; ``mixup`` on JAX's
  lambda and permutation within 1e-6, and ``mixup_batch``'s draws.

Tolerances as tests/test_torch_dit_train.py's: the loss within 1e-5
relative, each gradient element within 2^-7 relative plus 1e-6, the
parameters within a tenth of the learning rate, the EMA within 1e-6.  The
gradients are held at the first step only: after it the two sides'
parameters differ in their last bits, which moves some MX grid points of
the quantized weights, and the second step's gradients then differ by a
grid step (up to 5% of an element) on a few percent of the elements, as
the trajectory golden's later steps do (tests/
test_train_trajectory_golden.py).  AdamW divides each update by the
gradient's running magnitude, so where such a gradient is near zero its
parameter's second update can move by a good part of the learning rate:
the second step's parameters are held within a tenth of the learning rate
on at least 99% of their elements and within half of it on every one (the
second update is about half the learning rate an element, the cosine
schedule's rate at count 1, so a skipped or wrongly scheduled update
fails), its loss and EMA within the first step's bounds.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mx_quantization_tpu.models.vit import VitConfig as JaxVitConfig
from mx_quantization_tpu.models.vit import VitQuantConfig as JaxQuant
from mx_quantization_tpu.models.vit import init_vit as jax_init_vit
from mx_quantization_tpu.models.vit import vit_forward as jax_vit_forward
from mx_quantization_tpu.workloads import deit_train as jax_deit_train
from mx_quantization_tpu.workloads import losses as jax_losses
from mx_quantization_tpu.workloads.deit import \
    default_mx_specs as jax_deit_specs

from mx_quantization_tpu_torch.models.vit import VitConfig, VitQuantConfig
from mx_quantization_tpu_torch.utils.checkpoint import vit_params_from_jax
from mx_quantization_tpu_torch.workloads import losses
from mx_quantization_tpu_torch.workloads.deit import default_mx_specs
from mx_quantization_tpu_torch.workloads.deit_train import (
    _beta, cosine_decay, label_smoothing_ce, make_train_step, mixup,
    mixup_batch)

KW = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=128, depth=2,
          num_heads=2)
LR, STEPS = 5e-4, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread keeps the module's cost its own
    when the suite runs several processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaf(tree, name):
    parts, idx = name.split("."), None
    if parts[0] == "blocks":
        tree, idx, parts = tree["blocks"], int(parts[1]), parts[2:]
    for key in parts:
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) \
            else tree[key]
    return np.asarray(tree if idx is None else tree[idx])


def test_deit_train_steps_match_jax():
    kw = dict(mx_quant=True, top_k=True, k=6, pred_mode="ex_pred")
    jq = JaxQuant(mx_specs=jax_deit_specs().replace(quantize_backprop=True),
                  **kw)
    qcfg = VitQuantConfig(
        mx_specs=default_mx_specs().replace(quantize_backprop=True), **kw)
    jcfg = JaxVitConfig(**KW)
    params = jax_init_vit(jax.random.key(0), jcfg)
    model = vit_params_from_jax(jax.tree.map(np.asarray, params),
                                VitConfig(**KW), "cpu")
    rng = np.random.RandomState(3)
    batches = [(rng.randn(4, 3, 32, 32).astype(np.float32),
                rng.randint(0, 10, 4)) for _ in range(STEPS)]

    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, x, y: jax_deit_train.label_smoothing_ce(
            jax_vit_forward(p, x, jcfg, jq), y, 0.1)))
    opt = optax.adamw(optax.cosine_decay_schedule(LR, STEPS),
                      weight_decay=0.05)
    opt_state, ema = opt.init(params), params

    @jax.jit  # eager, the update's many small ops take seconds a step
    def jupdate(jg, opt_state, params, ema):
        updates, opt_state = opt.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax.tree.map(
            lambda e, p: 0.99996 * e + (1 - 0.99996) * p, ema, params)

    model.requires_grad_(True)
    tensors = list(model.parameters())
    tema = [p.detach().clone() for p in tensors]
    optimizer = torch.optim.AdamW(tensors, lr=LR, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.05)
    step = make_train_step(model, tema, qcfg, optimizer, LR, STEPS)
    for count, (x, y) in enumerate(batches):
        jl, jg = grad_fn(params, jnp.asarray(x), jnp.asarray(y))
        params, opt_state, ema = jupdate(jg, opt_state, params, ema)
        loss = step(count, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        near = []
        for (name, prm), e in zip(model.named_parameters(), tema):
            want = _leaf(jg, name)
            assert np.abs(want).max() > 0, name
            if count == 0:  # see the module's docstring for step 1
                np.testing.assert_allclose(prm.grad.numpy(), want,
                                           rtol=2.0 ** -7, atol=1e-6,
                                           err_msg=name)
            diff = np.abs(prm.detach().numpy() - _leaf(params, name))
            near.append((diff <= LR / 10).ravel())
            assert diff.max() <= (LR / 10 if count == 0 else LR / 2), name
            np.testing.assert_allclose(e.numpy(), _leaf(ema, name), rtol=0,
                                       atol=1e-6, err_msg=name)
        assert np.concatenate(near).mean() >= 0.99, count


def test_cosine_decay_matches_optax():
    """The learning rate ``make_train_step`` sets at each count, past the
    schedule's end included."""
    want = optax.cosine_decay_schedule(LR, 5)
    for c in range(7):
        np.testing.assert_allclose(cosine_decay(LR, 5, c), float(want(c)),
                                   rtol=1e-6, atol=1e-12)


def _logits(seed, n=6, c=10):
    return np.random.RandomState(seed).randn(n, c).astype(np.float32) * 2


def test_label_smoothing_ce_matches_jax():
    logits, labels = _logits(1), np.array([0, 3, 9, 1, 1, 4])
    for s in (0.0, 0.1):
        want = jax_deit_train.label_smoothing_ce(jnp.asarray(logits),
                                                 jnp.asarray(labels), s)
        got = label_smoothing_ce(torch.from_numpy(logits),
                                 torch.from_numpy(labels), s)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["none", "soft", "hard", "pair"])
def test_distillation_loss_matches_jax(kind):
    s, t = _logits(2), _logits(3)
    kd = _logits(4)
    labels = np.array([2, 3, 0, 9, 5, 5])
    dtype = "soft" if kind == "pair" else kind

    def jbase(o, y):
        return jax_deit_train.label_smoothing_ce(o, y, 0.1)

    def tbase(o, y):
        return label_smoothing_ce(o, y, 0.1)
    jout = (jnp.asarray(s), jnp.asarray(kd)) if kind == "pair" \
        else jnp.asarray(s)
    tout = (torch.from_numpy(s), torch.from_numpy(kd)) if kind == "pair" \
        else torch.from_numpy(s)
    want = jax_losses.distillation_loss(jbase, jout, jnp.asarray(labels),
                                        jnp.asarray(t), dtype, alpha=0.3,
                                        tau=2.0)
    got = losses.distillation_loss(tbase, tout, torch.from_numpy(labels),
                                   torch.from_numpy(t), dtype, alpha=0.3,
                                   tau=2.0)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        losses.soft_kl(torch.from_numpy(s), torch.from_numpy(t), 2.0).item(),
        float(jax_losses.soft_kl(jnp.asarray(s), jnp.asarray(t), 2.0)),
        rtol=1e-6)


def test_mixup_matches_jax_on_its_draws():
    """JAX draws lambda and the permutation from one key; given those, the
    port's ``mixup`` mixes as JAX's ``mixup_batch`` does."""
    x = np.random.RandomState(5).randn(6, 3, 4, 4).astype(np.float32)
    y = np.array([1, 0, 4, 4, 2, 3])
    key = jax.random.key(7)
    wx, wy = jax_deit_train.mixup_batch(key, jnp.asarray(x), jnp.asarray(y),
                                        5)
    lam = float(jax.random.beta(key, 0.8, 0.8))
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, 6)))
    gx, gy = mixup(torch.from_numpy(x), torch.from_numpy(y), 5, lam, perm)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-6,
                               atol=1e-6)


def test_mixup_batch_draws_from_the_generator():
    """The draws repeat with the generator's seed, the mixed labels sum to
    one, and lambda follows Beta(0.8, 0.8): mean 1/2, variance 0.64 /
    (2.56 * 2.6) = 0.0962 (4000 draws: standard errors 0.005 and 0.002)."""
    x = torch.randn(64, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    y = torch.arange(64) % 10
    a = mixup_batch(torch.Generator().manual_seed(1), x, y, 10)
    b = mixup_batch(torch.Generator().manual_seed(1), x, y, 10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    np.testing.assert_allclose(a[1].sum(-1).numpy(), 1.0, rtol=1e-6)
    gen = torch.Generator().manual_seed(2)
    lam = np.array([_beta(gen, 0.8, 0.8) for _ in range(4000)])
    assert 0 < lam.min() and lam.max() < 1
    assert abs(lam.mean() - 0.5) < 0.025 and abs(lam.var() - 0.0962) < 0.01


def test_deit_cli_runs_on_the_cpu():
    from mx_quantization_tpu_torch.workloads import deit_train
    import mx_quantization_tpu_torch.models.vit as vit
    cfgs = dict(vit.VIT_CONFIGS)
    try:
        vit.VIT_CONFIGS["deit_tiny_patch16_224"] = dataclasses.replace(
            cfgs["deit_tiny_patch16_224"], depth=1)
        model, ema = deit_train.main(["--device", "cpu", "--steps", "2",
                                      "--batch", "2", "--img-size", "32"])
    finally:
        vit.VIT_CONFIGS.clear()
        vit.VIT_CONFIGS.update(cfgs)
    assert set(ema) == {n for n, _ in model.named_parameters()}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
