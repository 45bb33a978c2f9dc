"""The port's PixArt-alpha sampling against the JAX package's: the
DPM-Solver++(2M) tables and schedule, 20 solver steps driven by one
closed-form eps function in both frameworks, ``sample_pixart`` on the tiny
model of tests/test_torch_pixart.py with JAX's initial noise replayed, and
the CLI on synthetic embeds.

As for DiT (tests/test_torch_sampling.py), sampled latents are not compared
through two independent forwards; ``sample_pixart`` is held to JAX's on the
port's own model outputs instead: JAX's sampler runs with each of its model
calls answered by the port's (after checking that JAX hands the model the
port's inputs), and must end where the port ends, within 1e-5 (the solver's
float32 arithmetic, expm1 included).  The first forward is checked stage by
stage, as in tests/test_torch_pixart.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.workloads.pixart as jax_workload
from mx_quantization_tpu.diffusion import \
    DPMSolverMultistep as JaxDPMSolver
from mx_quantization_tpu.models.pixart import \
    PixArtQuantConfig as JaxQuantConfig
from mx_quantization_tpu.workloads.pixart import pixart_mx_specs as jax_specs

from mx_quantization_tpu_torch.diffusion import DPMSolverMultistep
from mx_quantization_tpu_torch.models.pixart import PixArtQuantConfig
from mx_quantization_tpu_torch.workloads.pixart import (main,
                                                        pixart_mx_specs,
                                                        sample_pixart)
from test_torch_dit import _np
from test_torch_pixart import (QKW, TOKENS, check_stages, models,  # noqa: F401
                               record_calls)

WORKLOAD = importlib.import_module(
    "mx_quantization_tpu_torch.workloads.pixart")


@pytest.mark.parametrize("schedule", ["scaled_linear", "linear"])
def test_tables_and_timesteps_match_jax(schedule):
    a, b = JaxDPMSolver(beta_schedule=schedule), \
        DPMSolverMultistep(beta_schedule=schedule)
    for name in ("alpha_t", "sigma_t", "lambda_t"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for steps in (20, 7, 1):
        np.testing.assert_array_equal(a.timesteps(steps), b.timesteps(steps))


@pytest.mark.parametrize("order", [1, 2])
def test_twenty_solver_steps_match_jax(order):
    """A closed-form eps (no transcendental functions, so both frameworks
    compute it alike): the solvers' float32 arithmetic within 1e-5."""
    key = jax.random.key(order)
    shape = (3, 4, 6, 6)
    want = JaxDPMSolver(solver_order=order).sample(
        lambda x, t: 0.3 * x + 1e-3 * t[:, None, None, None], shape, key,
        num_inference_steps=20, jit_step=False)
    x = torch.from_numpy(np.asarray(jax.random.normal(key, shape)))
    got = DPMSolverMultistep(solver_order=order).sample(
        lambda x, t: 0.3 * x + 1e-3 * t[:, None, None, None], x,
        num_inference_steps=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _prompts(seed, n=2):
    rng = np.random.RandomState(seed)
    embeds = rng.randn(n, TOKENS, 32).astype(np.float32)
    mask = (np.arange(TOKENS)[None] <
            np.array([[TOKENS], [6]])[:n]).astype(np.int32)
    null = rng.randn(1, TOKENS, 32).astype(np.float32)
    return embeds, mask, null


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_sample_pixart_matches_jax_with_replayed_noise(models, contract,
                                                       monkeypatch):
    jcfg, jparams, _, model = models
    embeds, mask, null = _prompts(0)
    steps, key = 2, jax.random.key(3)
    z = np.asarray(jax.random.normal(key, (2, 4, 8, 8)))  # sample_pixart's
    pq = PixArtQuantConfig(mx_specs=pixart_mx_specs(), contract=contract,
                           **QKW)
    jq = JaxQuantConfig(mx_specs=jax_specs(), contract=contract, **QKW)

    forwards = []
    real_forward = WORKLOAD.pixart_forward

    def forward(*args, **kw):
        forwards.append((args, kw, real_forward(*args, **kw)))
        return forwards[-1][2]

    calls = record_calls(monkeypatch)
    monkeypatch.setattr(WORKLOAD, "pixart_forward", forward)
    got = sample_pixart(model, pq, *map(torch.from_numpy,
                                        (embeds, mask, null)),
                        num_steps=steps, latents=torch.from_numpy(z),
                        device="cpu")
    monkeypatch.undo()
    assert got.shape == (2, 4, 8, 8) and torch.isfinite(got).all()
    assert len(forwards) == steps

    # JAX's sampler, its model calls answered by the port's outputs
    answered = []

    def jax_forward(params, x2, ctx2, t2, cfg, qcfg, encoder_attention_mask,
                    timestep_idx, orthogonal_matrix):
        (_, px, pctx, pt, _), pkw, out = forwards[len(answered)]
        answered.append(True)
        for a, b in ((x2, px), (ctx2, pctx), (t2, pt),
                     (encoder_attention_mask, pkw["encoder_attention_mask"])):
            np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b))
        assert timestep_idx is None and orthogonal_matrix is None
        return jnp.asarray(_np(out))

    monkeypatch.setattr(jax_workload, "pixart_forward", jax_forward)
    with jax.disable_jit():
        want = jax_workload.sample_pixart(
            jparams, jcfg, jq, *map(jnp.asarray, (embeds, mask, null)), key,
            num_steps=steps)
    monkeypatch.undo()
    assert len(answered) == steps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    # the first forward, stage by stage
    first = next(i for i, c in enumerate(calls)
                 if c[0] == "pixart_final_layer")
    assert check_stages(monkeypatch, calls[:first + 1], model, jparams,
                        jcfg, jq) == 2 + jcfg.num_layers


def test_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "lat.npz"
    main(["--device", "cpu", "--num-layers", "2", "--num-heads", "2",
          "--caption-channels", "32", "--image-size", "64",
          "--max-token-length", str(TOKENS), "--num-steps", "2",
          "--mx-quant", "--self-top-k", "--self-k", "6",
          "--prompts", "a", "b", "--out", str(out)])
    lat = np.load(out)["latents"]
    assert lat.shape == (2, 4, 8, 8) and np.isfinite(lat).all()
    for flag in ("--t5-path", "--vae"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(["--device", "cpu", flag, str(tmp_path)])
