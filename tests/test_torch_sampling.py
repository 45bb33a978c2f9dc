"""The port's DDPM sampling against the JAX package's, with JAX's noise
replayed: ``p_sample_step`` on a closed-form model, and ``sample_dit`` over
3 respaced steps on a small randomized DiT at f32 activations.

``sample_dit``'s random draws are reproduced here from its
``jax.random.split`` sequence (workloads/dit.py: one split for the initial
latents, then one per step for the step noise) and handed to the port.  The
sampled latents are not compared end to end, for the reason
tests/test_torch_dit.py gives for whole forwards; instead each piece of
``sample_dit`` is held to JAX's on the port's own inputs:
  * the loop: JAX's ``sample_dit``, each of its denoise steps answered
    with the port's next state, hands its steps the port's first state,
    labels and step indices, and the keys the test replayed, and returns
    the port's result; the port's steps each start from the last one's
    result;
  * each diffusion step, against JAX's ``p_sample_step`` from the same
    state with the port's model output and the step's key (as
    ``test_p_sample_step_matches_jax``);
  * each model forward, stage by stage, and its CFG guidance, as in
    tests/test_torch_dit.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mx_quantization_tpu.diffusion import create_diffusion as jax_diffusion
from mx_quantization_tpu.models.dit import DiTConfig as JaxDiTConfig
from mx_quantization_tpu.models.dit import DiTQuantConfig as JaxQuantConfig
from mx_quantization_tpu.models.dit import init_dit as jax_init_dit
from mx_quantization_tpu.workloads.dit import dit_mx_specs as jax_specs
from mx_quantization_tpu.workloads.dit import sample_dit as jax_sample_dit

import mx_quantization_tpu.workloads.dit as jax_workloads

from mx_quantization_tpu_torch.diffusion import (create_diffusion,
                                                 space_timesteps)
from mx_quantization_tpu_torch.models.dit import DiTConfig, DiTQuantConfig
from mx_quantization_tpu_torch.utils.checkpoint import dit_params_from_jax
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs, sample_dit
from test_torch_dit import check_cfg_guidance, check_stages, record_stages

WORKLOADS = importlib.import_module("mx_quantization_tpu_torch.workloads.dit")


def _toy_jax(x, t):
    return jnp.concatenate([0.3 * x + 1e-3 * t[:, None, None, None],
                            0.5 * jnp.tanh(x)], axis=1)


def _toy_torch(x, t):
    return torch.cat([0.3 * x + 1e-3 * t[:, None, None, None],
                      0.5 * torch.tanh(x)], dim=1)


@pytest.mark.parametrize("steps", ["100", "3", "ddim10"])
def test_tables_and_respacing_match_jax(steps):
    a, b = jax_diffusion(steps), create_diffusion(steps)
    np.testing.assert_array_equal(a.timestep_map, b.timestep_map)
    for name in ("betas", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert space_timesteps(1000, "10,20") == set(
        __import__("mx_quantization_tpu.diffusion.gaussian", fromlist=["x"]
                   ).space_timesteps(1000, "10,20"))


@pytest.mark.parametrize("i", [0, 1, 57, 99])
def test_p_sample_step_matches_jax(i):
    rng = np.random.RandomState(i)
    x = rng.randn(3, 4, 6, 6).astype(np.float32)
    key = jax.random.key(i)
    want = jax_diffusion("100").p_sample_step(_toy_jax, jnp.asarray(x), i,
                                              key)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    got = create_diffusion("100").p_sample_step(
        _toy_torch, torch.from_numpy(x), i, torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def record_steps(monkeypatch):
    """Record each diffusion step ``sample_dit`` takes as (state, index,
    noise, labels, timesteps, model output, next state)."""
    steps = []
    real_create = WORKLOADS.create_diffusion

    def create(spec):
        diffusion = real_create(spec)
        real_step = diffusion.p_sample_step

        def step(model_fn, x, i, noise, model_kwargs=None):
            seen = []

            def fn(xt, t, **kw):
                seen.append((t, model_fn(xt, t, **kw)))
                return seen[-1][1]

            nxt = real_step(fn, x, i, noise, model_kwargs=model_kwargs)
            steps.append((x, i, noise, model_kwargs["y"], *seen[0], nxt))
            return nxt

        diffusion.p_sample_step = step
        return diffusion

    monkeypatch.setattr(WORKLOADS, "create_diffusion", create)
    return steps


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_sample_dit_matches_jax_with_replayed_noise(contract, monkeypatch):
    kw = dict(input_size=8, hidden_size=288, depth=2, num_heads=4,
              num_classes=10)
    jcfg = JaxDiTConfig(**kw)
    rng = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: (0.05 * rng.randn(*a.shape)).astype(np.float32),
        jax_init_dit(jax.random.key(0), jcfg))
    qkw = dict(mx_quant=True, top_k=True, k=6, ex_pred=True,
               exclude_blocks=(1,), topk_key_bits=8, contract=contract)
    jq = JaxQuantConfig(mx_specs=jax_specs(), **qkw)
    labels, steps, seed = [1, 3], 3, 7

    # sample_dit's draws: split for z, then one split per step
    key = jax.random.key(seed)
    key, zk = jax.random.split(key)
    z = torch.from_numpy(np.asarray(jax.random.normal(zk, (2, 4, 8, 8))))
    keys, noise = [], []
    for _ in range(steps):
        key, sk = jax.random.split(key)
        keys.append(sk)
        noise.append(torch.from_numpy(np.asarray(
            jax.random.normal(sk, (4, 4, 8, 8), jnp.float32))))
    model = dit_params_from_jax(tree, DiTConfig(**kw), device="cpu")
    taken = record_steps(monkeypatch)
    calls = record_stages(monkeypatch)
    got = sample_dit(model, DiTQuantConfig(mx_specs=dit_mx_specs(), **qkw),
                     labels, num_steps=steps, cfg_scale=4.0, z=z,
                     step_noise=noise, device="cpu")
    monkeypatch.undo()
    assert got.shape == (2, 4, 8, 8) and torch.isfinite(got).all()

    # the loop
    for (*_, nxt), (x, *_) in zip(taken, taken[1:]):
        assert x is nxt
    for (_, _, n, *_), want_n in zip(taken, noise):
        assert torch.equal(n, want_n)
    jax_steps = []

    def jax_step(params, x, i, sk, y, om, **kw):
        jax_steps.append((x, int(i), sk, y))
        return jnp.asarray(taken[len(jax_steps) - 1][-1].numpy())

    monkeypatch.setattr(jax_workloads, "_dit_sample_step", jax_step)
    jparams = jax.tree.map(jnp.asarray, tree)
    want = jax_sample_dit(jparams, jcfg, jq, labels, jax.random.key(seed),
                          num_steps=steps, cfg_scale=4.0)
    monkeypatch.undo()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(jax_steps) == steps
    for (x, i, sk, y), (px, pi, _, py, *_), want_sk in zip(jax_steps, taken,
                                                           keys):
        assert i == pi
        np.testing.assert_array_equal(np.asarray(x), px.numpy())
        np.testing.assert_array_equal(np.asarray(y), py.numpy())
        np.testing.assert_array_equal(jax.random.key_data(sk),
                                      jax.random.key_data(want_sk))

    # each diffusion step from the port's state and model output
    for (x, i, _, _, _, out, nxt), sk in zip(taken, keys):
        want = jax_diffusion(str(steps)).p_sample_step(
            lambda *a, out=out, **k: jnp.asarray(out.numpy()),
            jnp.asarray(x.numpy()), i, sk)
        np.testing.assert_allclose(nxt.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    # each forward, stage by stage, and its CFG guidance
    check_stages(monkeypatch, calls, model, jparams, jcfg, jq)
    inner = [out for name, _, _, out in calls if name == "dit_final_layer"]
    for (x, _, _, y, t, out, _), inner_out in zip(taken, inner):
        check_cfg_guidance(monkeypatch, out, inner_out, x, t, y, jcfg, jq,
                           4.0)
