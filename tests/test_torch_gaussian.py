"""The port's Gaussian diffusion against the JAX package's and against the
reference engine's goldens (tests/golden/diffusion.npz, JAX's bounds in
tests/test_diffusion_golden.py): the linear and squaredcos tables per
respacing, ``q_sample`` and ``p_mean_variance``, the DDIM(eta=0) chain, the
DDPM and DDIM loops with JAX's split-key noise handed to the port, and
``sample_for_fid``'s label shards.
"""

import importlib
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mx_quantization_tpu.diffusion import create_diffusion as jax_diffusion
from mx_quantization_tpu.models.dit import DiTConfig as JaxDiTConfig
import mx_quantization_tpu.workloads.dit as jax_workloads

from mx_quantization_tpu_torch.diffusion import create_diffusion
from mx_quantization_tpu_torch.diffusion.gaussian import \
    squaredcos_beta_schedule
from mx_quantization_tpu_torch.models.dit import (DiTConfig, DiTQuantConfig,
                                                  init_dit)
from mx_quantization_tpu_torch.workloads.dit import sample_dit, sample_for_fid

WORKLOADS = importlib.import_module("mx_quantization_tpu_torch.workloads.dit")
GOLD = os.path.join(os.path.dirname(__file__), "golden", "diffusion.npz")
SPACINGS = {"train": None, "s100": "100", "ddim25": "ddim25"}
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_log_variance_clipped",
          "posterior_mean_coef1", "posterior_mean_coef2")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread keeps the module's cost its own
    when the suite runs several processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLD)


def toy_jax(x, t, **kw):
    tt = t.astype(jnp.float32).reshape(-1, 1, 1, 1)
    return jnp.concatenate([0.3 * x + 0.01 * tt / 1000.0, jnp.tanh(x)],
                           axis=1)


def toy_torch(x, t, **kw):
    tt = t.to(torch.float32).reshape(-1, 1, 1, 1)
    return torch.cat([0.3 * x + 0.01 * tt / 1000.0, torch.tanh(x)], dim=1)


@pytest.mark.parametrize("schedule", ["linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("tag", list(SPACINGS))
def test_schedule_tables_match_jax_and_goldens(golden, schedule, tag):
    a = jax_diffusion(SPACINGS[tag], noise_schedule=schedule)
    b = create_diffusion(SPACINGS[tag], noise_schedule=schedule)
    np.testing.assert_array_equal(a.timestep_map, b.timestep_map)
    for name in TABLES:
        np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                   rtol=1e-12, err_msg=name)
    if schedule != "linear":
        return
    np.testing.assert_allclose(b.betas, golden[f"{tag}_betas"], rtol=1e-12)
    for name, key in (("posterior_log_variance_clipped", "post_logvar"),
                      ("posterior_mean_coef1", "post_mean_c1"),
                      ("posterior_mean_coef2", "post_mean_c2")):
        np.testing.assert_allclose(getattr(b, name), golden[f"{tag}_{key}"],
                                   rtol=1e-10)
    np.testing.assert_array_equal(b.timestep_map,
                                  golden[f"{tag}_timestep_map"])


def test_squaredcos_and_unknown_schedule():
    from mx_quantization_tpu.diffusion.gaussian import \
        squaredcos_beta_schedule as jax_squaredcos
    np.testing.assert_array_equal(squaredcos_beta_schedule(50),
                                  jax_squaredcos(50))
    with pytest.raises(ValueError, match="unknown schedule"):
        create_diffusion(noise_schedule="cosine")
    with pytest.raises(ValueError, match="unknown schedule"):
        jax_diffusion(noise_schedule="cosine")


@pytest.mark.parametrize("tag", list(SPACINGS))
def test_qsample_and_p_mean_variance_match_goldens(golden, tag):
    d = create_diffusion(SPACINGS[tag])
    x, x0, noise = (torch.from_numpy(golden[f"{tag}_{k}"])
                    for k in ("x", "x0", "noise"))
    t = torch.tensor([0, d.num_timesteps - 1])
    tol = dict(rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(d.q_sample(x0, t, noise).numpy(),
                               golden[f"{tag}_qsample"], **tol)
    out = toy_torch(x, d.model_t(t).to(torch.float32))
    mean, log_var, pred_x0 = d.p_mean_variance(out, x, t)
    np.testing.assert_allclose(mean.numpy(), golden[f"{tag}_pmv_mean"],
                               **tol)
    np.testing.assert_allclose(log_var.numpy(), golden[f"{tag}_pmv_logvar"],
                               **tol)
    np.testing.assert_allclose(pred_x0.numpy(), golden[f"{tag}_pmv_predx0"],
                               **tol)
    # the tables stay on the device after the first gather
    assert d.device_tables("cpu") is d.device_tables(torch.device("cpu"))


def test_deterministic_ddim_chain_matches_goldens(golden):
    d = create_diffusion("ddim10")
    z = torch.from_numpy(golden["ddim_chain_z"])
    out = d.ddim_sample_loop(toy_torch, z.shape, noise=z,
                             step_noise=[torch.zeros_like(z)] * 10, eta=0.0)
    np.testing.assert_allclose(out.numpy(), golden["ddim_chain_out"],
                               rtol=2e-4, atol=2e-4)


def _jax_loop_noise(key, shape, steps):
    """JAX's loops' draws: one split for the initial noise, then one per
    step."""
    key, nk = jax.random.split(key)
    z = np.asarray(jax.random.normal(nk, shape))
    noise = []
    for _ in range(steps):
        key, sk = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sk, shape, jnp.float32)))
    return z, noise


def denoiser_jax(x, t, **kw):
    return jnp.concatenate([0.95 * x + 1e-3 * t[:, None, None, None],
                            jnp.tanh(x)], axis=1)


def denoiser_torch(x, t, **kw):
    return torch.cat([0.95 * x + 1e-3 * t[:, None, None, None],
                      torch.tanh(x)], dim=1)


@pytest.mark.parametrize("loop,eta", [("ddpm", None), ("ddim", 0.0),
                                      ("ddim", 1.0)])
def test_sample_loops_match_jax(loop, eta):
    """Whole loops on a toy that reads its input as mostly noise, as a
    trained model does at high t, so the chain stays in the latents' range
    (``toy_torch``'s eps = 0.3 x blows DDIM(eta=1) up to |x| ~ 60, where
    one f32 step of the frameworks' sqrt and exp spreads past 1e-6)."""
    shape, spacing, key = (2, 4, 6, 6), "8", jax.random.key(5)
    a, b = jax_diffusion(spacing), create_diffusion(spacing)
    z, noise = _jax_loop_noise(key, shape, b.num_timesteps)
    kw = dict(noise=torch.from_numpy(z),
              step_noise=[torch.from_numpy(n) for n in noise])
    if loop == "ddpm":
        want = a.p_sample_loop(denoiser_jax, shape, key)
        got = b.p_sample_loop(denoiser_torch, shape, **kw)
    else:
        want = a.ddim_sample_loop(denoiser_jax, shape, key, eta=eta)
        got = b.ddim_sample_loop(denoiser_torch, shape, eta=eta, **kw)
    assert np.abs(np.asarray(want)).max() < 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_loops_draw_from_the_generator_in_order(loop):
    d, shape = create_diffusion("4"), (2, 4, 4, 4)
    got = getattr(d, loop)(toy_torch, shape,
                           generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    z = torch.randn(shape, generator=g)
    steps = [torch.randn(shape, generator=g) for _ in range(4)]
    want = getattr(d, loop)(toy_torch, shape, noise=z, step_noise=steps)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="generator"):
        getattr(d, loop)(toy_torch, shape)


@pytest.mark.parametrize("num,batch,rank,world,start", [
    (10, 4, 0, 1, 0), (10, 3, 1, 2, 0), (23, 4, 2, 3, 2), (7, 8, 1, 4, 1),
    (5, 2, 0, 2, 3)])
def test_sample_for_fid_shards_match_jax(monkeypatch, num, batch, rank,
                                         world, start):
    seen = {"jax": [], "torch": []}

    def jax_stub(params, cfg, qcfg, labels, key, **kw):
        seen["jax"].append(list(np.asarray(labels)))
        return np.zeros((len(labels), 1))

    def torch_stub(model, qcfg, labels, generator, **kw):
        seen["torch"].append(list(labels))
        return torch.zeros(len(labels), 1)

    monkeypatch.setattr(jax_workloads, "sample_dit", jax_stub)
    monkeypatch.setattr(WORKLOADS, "sample_dit", torch_stub)
    want = jax_workloads.sample_for_fid(
        None, JaxDiTConfig(num_classes=7), None, num, batch,
        jax.random.key(0), rank=rank, world=world, start_index=start)
    got = sample_for_fid(types.SimpleNamespace(cfg=DiTConfig(num_classes=7)),
                         None, num, batch, rank=rank, world=world,
                         start_index=start, device="cpu")
    assert seen["torch"] == seen["jax"]
    assert got.shape == want.shape


def test_sample_for_fid_batches_through_sample_dit():
    cfg = DiTConfig(input_size=8, hidden_size=64, depth=2, num_heads=2,
                    num_classes=10)
    model = init_dit(cfg, torch.Generator().manual_seed(0), "cpu",
                     randomize_all=True)
    qcfg = DiTQuantConfig()
    got = sample_for_fid(model, qcfg, 5, 2, torch.Generator().manual_seed(1),
                         rank=0, world=2, num_steps=2, device="cpu")
    g = torch.Generator().manual_seed(1)
    want = np.concatenate([
        sample_dit(model, qcfg, labels, g, num_steps=2, cfg_scale=1.5,
                   device="cpu").numpy() for labels in ([0, 2], [4])])
    assert got.shape == (3, 4, 8, 8)
    np.testing.assert_array_equal(got, want)
