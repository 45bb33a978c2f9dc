"""The port's continuous-batching server against the JAX package's
``serving.py``: ``dpm_tables`` bit for bit; ``engine_step`` and
``engine_step_dpm`` on one closed-form toy model with the same noise, slots
at mixed depths and some inactive; JAX's tests/test_serving.py scenarios on
the port; a lockstep wave of a small fused-engine DiT with top-k through the
server, bit-equal to ``sample_dit`` with the server's noise replayed; the
server's raises.  The bench's serve and summary functions at a tiny size.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mx_quantization_tpu.diffusion import create_diffusion as jax_diffusion
from mx_quantization_tpu.serving import dpm_tables as jax_dpm_tables
from mx_quantization_tpu.serving import engine_step as jax_engine_step
from mx_quantization_tpu.serving import \
    engine_step_dpm as jax_engine_step_dpm

from mx_quantization_tpu_torch.diffusion import (DPMSolverMultistep,
                                                 create_diffusion)
from mx_quantization_tpu_torch.models.dit import (DiTConfig, DiTQuantConfig,
                                                  dit_forward, init_dit)
from mx_quantization_tpu_torch.models.pixart import (PixArtConfig,
                                                     PixArtQuantConfig,
                                                     init_pixart,
                                                     pixart_forward)
from mx_quantization_tpu_torch.serving import (DiffusionServer, Request,
                                               dpm_tables, engine_step,
                                               engine_step_dpm)
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs, sample_dit
from mx_quantization_tpu_torch.workloads.pixart import pixart_mx_specs

BENCH = importlib.import_module(
    "mx_quantization_tpu_torch.tools.serving_bench")
TINY = DiTConfig(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                 depth=2, num_heads=2, num_classes=10)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small models: one torch thread keeps the module's cost its own when
    the suite runs several processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_dit():
    model = init_dit(TINY, torch.Generator().manual_seed(0), "cpu",
                     randomize_all=True)

    def model_fn(x, t, y):
        return dit_forward(model, x, t, y, DiTQuantConfig())
    return model_fn


@pytest.mark.parametrize("steps", [7, 20])
def test_dpm_tables_bit_equal_jax(steps):
    want = jax_dpm_tables(steps)
    got = dpm_tables(steps)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# one closed-form model on both sides: (2S, C, H, W) latents, (2S,)
# timesteps and the condition -> (2S, 2C, H, W)
def toy_jax(x, t, y):
    c = (y.astype(jnp.float32) if not isinstance(y, dict) else
         (y["embeds"].mean(axis=(1, 2)) * y["mask"].sum(axis=1)))
    eps = 0.3 * x + 1e-3 * t[:, None, None, None] + 0.01 * c[:, None, None,
                                                             None]
    return jnp.concatenate([eps, 0.5 * jnp.tanh(x)], axis=1)


def toy_torch(x, t, y):
    c = (y.to(torch.float32) if not isinstance(y, dict) else
         (y["embeds"].mean(dim=(1, 2)) * y["mask"].sum(dim=1)))
    eps = 0.3 * x + 1e-3 * t[:, None, None, None] + 0.01 * c[:, None, None,
                                                             None]
    return torch.cat([eps, 0.5 * torch.tanh(x)], dim=1)


def _pool(rng, S, C=4, HW=4):
    lat = rng.randn(S, C, HW, HW).astype(np.float32)
    return lat, rng.randn(S, C, HW, HW).astype(np.float32)


def _compare(got, want, exact=()):
    for i, (g, w) in enumerate(zip(got, want)):
        if i in exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_engine_step_matches_jax():
    rng = np.random.RandomState(0)
    S, steps = 5, "10"
    lat, _ = _pool(rng, S)
    step_idx = np.array([9, 0, 4, 1, 0])
    active = np.array([True, True, False, True, False])
    cond = np.array([3, 1, 7, 2, 0])
    key = jax.random.key(4)
    noise = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
    want = jax_engine_step(toy_jax, jax_diffusion(steps), np.asarray(10),
                           4.0, S, None, jnp.asarray(lat),
                           jnp.asarray(step_idx, jnp.int32),
                           jnp.asarray(active), jnp.asarray(cond), key)
    got = engine_step(toy_torch, create_diffusion(steps), torch.tensor(10),
                      4.0, S, None, torch.from_numpy(lat),
                      torch.from_numpy(step_idx), torch.from_numpy(active),
                      torch.from_numpy(cond), torch.from_numpy(noise))
    _compare(got, want, exact=(1, 2, 3))
    assert got[3].tolist() == [False, True, False, False, False]


def test_engine_step_dpm_matches_jax():
    rng = np.random.RandomState(1)
    S, NI, L, E = 5, 6, 3, 8
    lat, prev_x0 = _pool(rng, S)
    step_idx = np.array([5, 0, 3, 5, 1])
    active = np.array([True, True, True, False, True])
    cond = {"embeds": rng.randn(S, L, E).astype(np.float32),
            "mask": (rng.rand(S, L) > 0.3).astype(np.float32)}
    null = {"embeds": rng.randn(L, E).astype(np.float32),
            "mask": np.ones(L, np.float32)}
    want = jax_engine_step_dpm(
        toy_jax, jax_dpm_tables(NI), null, 4.5, S, 4, None,
        jnp.asarray(lat), jnp.asarray(step_idx, jnp.int32),
        jnp.asarray(prev_x0), jnp.asarray(active),
        {k: jnp.asarray(v) for k, v in cond.items()})
    got = engine_step_dpm(
        toy_torch, dpm_tables(NI), {k: torch.from_numpy(v)
                                    for k, v in null.items()},
        4.5, S, 4, None, torch.from_numpy(lat), torch.from_numpy(step_idx),
        torch.from_numpy(prev_x0), torch.from_numpy(active),
        {k: torch.from_numpy(v) for k, v in cond.items()})
    _compare(got, want, exact=(1, 3, 4))


def test_continuous_batching_server(tiny_dit):
    srv = DiffusionServer(tiny_dit, (4, 8, 8), num_steps=4, slots=3,
                          null_condition=10, device="cpu")
    # five requests into three slots: continuous batching drains them all
    for i in range(5):
        srv.submit(Request(request_id=i, condition=i % 10))
    results = srv.run_until_drained()
    assert sorted(results) == [0, 1, 2, 3, 4]
    for r in results.values():
        assert r.latent.shape == (4, 8, 8)
        assert np.isfinite(r.latent).all()
        assert r.steps == 4
        assert r.latency_s >= r.queue_wait_s >= 0


def test_server_staggered_arrivals(tiny_dit):
    srv = DiffusionServer(tiny_dit, (4, 8, 8), num_steps=3, slots=2,
                          null_condition=10, device="cpu")
    srv.submit(Request(request_id=0, condition=1))
    srv.step()  # slot 0 mid-flight
    srv.submit(Request(request_id=1, condition=2))  # joins at a later step
    results = srv.run_until_drained()
    assert sorted(results) == [0, 1]
    assert results[0].steps == results[1].steps == 3


def test_server_skips_dispatch_at_drain_boundary():
    """Exactly num_steps dispatches serve a one-wave workload."""
    def model_fn(lat, t, y):
        return torch.cat([0.01 * lat, torch.zeros_like(lat)], dim=1)

    srv = DiffusionServer(model_fn, (4, 4, 4), num_steps=5, slots=4,
                          null_condition=10, device="cpu")
    for i in range(4):
        srv.submit(Request(i, i % 10))
    assert len(srv.run_until_drained()) == 4
    assert srv.dispatches == 5


def _tiny_pixart():
    cfg = PixArtConfig(num_attention_heads=2, attention_head_dim=32,
                       num_layers=2, sample_size=8, patch_size=2,
                       cross_attention_dim=64, caption_channels=48,
                       micro_conds=False)
    return cfg, init_pixart(cfg, torch.Generator().manual_seed(0), "cpu")


def _text(rng, L=6):
    return {"embeds": rng.randn(L, 48).astype(np.float32) * 0.02,
            "mask": (np.arange(L) < rng.randint(2, L + 1)).astype(
                np.float32)}


@pytest.mark.parametrize("solver", ["ddpm", "dpm++"])
def test_server_pixart_text_conditioning(solver):
    """Dict conditions carry per-request T5 embeds and masks; DDPM
    unquantized as JAX's text-conditioning test, DPM-Solver++ at the
    operating point's semantics (MXINT8, self top-k two_step) with
    staggered arrivals, as JAX's quantized test."""
    cfg, model = _tiny_pixart()
    if solver == "dpm++":
        qcfg = PixArtQuantConfig(
            mx_specs=pixart_mx_specs("fused"), mx_quant=True,
            self_top_k=True, self_k=8, ex_pred=True,
            pred_mode="two_step_leading_ones")
    else:
        qcfg = PixArtQuantConfig()

    def model_fn(p, x, t, cond):
        return pixart_forward(p, x, cond["embeds"], t, qcfg,
                              encoder_attention_mask=cond["mask"])

    rng = np.random.RandomState(0)
    null = {"embeds": rng.randn(6, 48).astype(np.float32) * 0.02,
            "mask": np.ones((6,), np.float32)}
    srv = DiffusionServer(model_fn, (4, 8, 8), num_steps=4, slots=2,
                          solver=solver, cfg_scale=4.5, params=model,
                          null_condition=null, device="cpu")
    srv.submit(Request(request_id=0, condition=_text(rng)))
    srv.step()
    for i in (1, 2):
        srv.submit(Request(request_id=i, condition=_text(rng)))
    results = srv.run_until_drained()
    assert sorted(results) == [0, 1, 2]
    for r in results.values():
        assert r.latent.shape == (4, 8, 8)
        assert np.isfinite(r.latent).all()
        assert r.steps == 4


def test_server_dpm_matches_sequential_solver(tiny_dit):
    """The server's DPM-Solver++(2M) against the sequential solver's math
    in float64 coefficients from the slot's initial noise (JAX's test and
    bound)."""
    C, NI = 4, 5
    srv = DiffusionServer(tiny_dit, (4, 8, 8), num_steps=NI, slots=2,
                          solver="dpm++", eps_channels=C, cfg_scale=4.0,
                          null_condition=10, device="cpu")
    srv.submit(Request(request_id=0, condition=3))
    srv._fill_slots()
    x = srv._lat[0].clone()[None]            # the slot's initial noise
    got = srv.run_until_drained()[0].latent

    sv = DPMSolverMultistep()
    ts = sv.timesteps(NI)
    y2 = torch.tensor([3, 10])
    prev_x0 = prev_t = None
    with torch.no_grad():
        for si, t_idx in enumerate(ts):
            out = tiny_dit(torch.cat([x, x]), torch.full((2,), float(t_idx)),
                           y2)
            c_eps, u_eps = out[:, :C].chunk(2, dim=0)
            eps = u_eps + 4.0 * (c_eps - u_eps)
            a, sg = float(sv.alpha_t[t_idx]), float(sv.sigma_t[t_idx])
            x0 = (x - sg * eps) / a
            s_t = int(ts[si + 1]) if si + 1 < len(ts) else 0
            h = float(sv.lambda_t[s_t] - sv.lambda_t[t_idx])
            a_s, sg_s = float(sv.alpha_t[s_t]), float(sv.sigma_t[s_t])
            d = x0
            if prev_x0 is not None:
                r = float(sv.lambda_t[t_idx] - sv.lambda_t[prev_t]) / h
                d = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * prev_x0
            x = (sg_s / sg) * x - a_s * float(np.expm1(-h)) * d
            prev_x0, prev_t = x0, t_idx
    np.testing.assert_allclose(got, x[0].numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_lockstep_wave_bit_equal_sample_dit(contract):
    """A burst that fills every slot runs in lockstep: the server's latents
    are sample_dit's, bit for bit, with the server's noise replayed (one
    (C, H, W) draw per slot, then one (slots, C, H, W) draw per step)."""
    cfg = DiTConfig(input_size=8, hidden_size=64, depth=2, num_heads=2,
                    num_classes=10)
    model = init_dit(cfg, torch.Generator().manual_seed(0), "cpu",
                     randomize_all=True)
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), mx_quant=True, top_k=True,
                          k=6, exclude_blocks=(1,), topk_key_bits=8,
                          contract=contract, activation_dtype="bfloat16")
    labels, steps, seed, shape = [1, 3, 7], 3, 11, (4, 8, 8)

    def model_fn(x, t, y):
        return dit_forward(model, x, t, y, qcfg)

    srv = DiffusionServer(model_fn, shape, num_steps=steps, slots=3,
                          null_condition=10, seed=seed, device="cpu")
    for i, y in enumerate(labels):
        srv.submit(Request(i, y))
    res = srv.run_until_drained()
    assert srv.dispatches == steps

    g = torch.Generator().manual_seed(seed)
    z = torch.stack([torch.randn(shape, generator=g) for _ in labels])
    noise = [torch.randn((3,) + shape, generator=g) for _ in range(steps)]
    want = sample_dit(model, qcfg, labels, num_steps=steps, z=z,
                      step_noise=[torch.cat([n, n]) for n in noise],
                      device="cpu")
    for i in range(len(labels)):
        assert torch.equal(torch.from_numpy(res[i].latent), want[i])


def test_server_raises():
    with pytest.raises(ValueError, match="unknown solver"):
        DiffusionServer(toy_torch, (4, 4, 4), num_steps=3, solver="euler",
                        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DiffusionServer(toy_torch, (4, 4, 4), num_steps=3, mesh=object(),
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DiffusionServer(toy_torch, (4, 4, 4), num_steps=3)


@pytest.mark.parametrize("arrival", ["burst", "staggered"])
def test_bench_serve_and_summary(tiny_dit, arrival):
    srv = DiffusionServer(tiny_dit, (4, 8, 8), num_steps=3, slots=2,
                          null_condition=10, device="cpu")
    run = BENCH.serve(srv, BENCH.dit_request, 5,
                      period=1 if arrival == "staggered" else None)
    assert sorted(run["results"]) == [10000 + i for i in range(5)]
    stats = BENCH.summary(run)
    assert stats["reqs"] == 5 and stats["dispatches"] == run["dispatches"]
    for key in ("imgs_per_s", "latency_p50_s", "latency_p95_s",
                "queue_wait_p50_s", "queue_wait_p95_s", "step_ms"):
        assert np.isfinite(stats[key]) and stats[key] >= 0
