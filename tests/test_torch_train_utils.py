"""The training path's pieces outside the model, against the JAX package on
the same seeded inputs:

* ``GaussianDiffusion.training_losses`` with a fixed model function, an
  explicit t (0 included: the decoder NLL) and noise, with and without the
  learned variance: every term within 1e-5 relative; the VB term's mean is
  detached (its gradient reaches only the variance channels, as JAX's
  stop-gradient does); and ``_discretized_gaussian_log_likelihood`` at
  the clamp edges;
* the timestep samplers: ``UniformSampler``'s range and weights,
  ``LossSecondMomentResampler``'s weights and its ring-buffer ``update``
  equal to JAX's;
* the data copies: ``ra_sampler_indices``, ``latent_npz_dataset`` and
  ``build_dataset("CIFAR10" / "CIFAR100")`` on temporary pickles, equal to
  JAX's; ``three_augment`` on one PIL image with the same RandomState;
* ``save_params`` / ``load_params`` round trip, and ``dit_train.train``
  writing ``{"model", "ema"}`` checkpoints; the DiT CLI on the CPU.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mx_quantization_tpu.data import augment as jax_augment
from mx_quantization_tpu.data import datasets as jax_datasets
from mx_quantization_tpu.data.samplers import \
    ra_sampler_indices as jax_ra_indices
from mx_quantization_tpu.diffusion import create_diffusion as jax_diffusion
from mx_quantization_tpu.diffusion import timestep_sampler as jax_ts

from mx_quantization_tpu_torch.data import augment, datasets
from mx_quantization_tpu_torch.data.samplers import ra_sampler_indices
from mx_quantization_tpu_torch.diffusion import (LossSecondMomentResampler,
                                                 UniformSampler,
                                                 create_diffusion)
from mx_quantization_tpu_torch.models.dit import DiTConfig, DiTQuantConfig
from mx_quantization_tpu_torch.utils.checkpoint import (load_params,
                                                        save_params)
from mx_quantization_tpu_torch.workloads import dit_train


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread keeps the module's cost its own
    when the suite runs several processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def toy_jax(x, t, y):
    tt = t.astype(jnp.float32).reshape(-1, 1, 1, 1)
    return jnp.concatenate([0.3 * x + 0.01 * tt / 1000.0 + 0.1 * y[:, None,
                                                                   None,
                                                                   None],
                            jnp.tanh(x)], axis=1)


def toy_torch(x, t, y):
    tt = t.to(torch.float32).reshape(-1, 1, 1, 1)
    return torch.cat([0.3 * x + 0.01 * tt / 1000.0 + 0.1 * y[:, None, None,
                                                             None],
                      torch.tanh(x)], dim=1)


@pytest.mark.parametrize("learn_sigma", [True, False])
@pytest.mark.parametrize("spacing", [None, "100"])
def test_training_losses_match_jax(learn_sigma, spacing):
    rng = np.random.RandomState(0)
    x0 = np.clip(rng.randn(4, 4, 8, 8), -1.2, 1.2).astype(np.float32)
    noise = rng.randn(4, 4, 8, 8).astype(np.float32)
    y = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    T = 1000 if spacing is None else 100
    t = np.array([0, 1, T // 2, T - 1])
    c = 8 if learn_sigma else 4  # (eps, v) or eps alone

    def jmodel(x, t, y):
        return toy_jax(x, t, y)[:, :c]

    def tmodel(x, t, y):
        return toy_torch(x, t, y)[:, :c]
    want = jax_diffusion(spacing, learn_sigma=learn_sigma).training_losses(
        jmodel, jnp.asarray(x0), jnp.asarray(t), None,
        model_kwargs={"y": jnp.asarray(y)}, noise=jnp.asarray(noise))
    got = create_diffusion(spacing, learn_sigma=learn_sigma).training_losses(
        tmodel, torch.from_numpy(x0), torch.from_numpy(t),
        model_kwargs={"y": torch.from_numpy(y)},
        noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)


def test_training_losses_draw_noise_and_stop_the_mean_gradient():
    """The noise comes from the generator (the same draw twice), and the VB
    term's gradient reaches the variance channels only: JAX's
    ``stop_gradient(eps)``."""
    d = create_diffusion(None)
    x0 = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([0, 400])
    out = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(1),
                      requires_grad=True)
    a = d.training_losses(lambda x, t: out, x0, t,
                          torch.Generator().manual_seed(2))
    b = d.training_losses(lambda x, t: out, x0, t,
                          torch.Generator().manual_seed(2))
    assert torch.equal(a["loss"], b["loss"])
    (g_vb,) = torch.autograd.grad(a["vb"].sum(), out)
    assert not g_vb[:, :4].any() and g_vb[:, 4:].abs().sum() > 0
    with pytest.raises(ValueError, match="generator or noise"):
        d.training_losses(lambda x, t: out, x0, t)


def test_discretized_log_likelihood_matches_jax():
    x = np.array([-1.0, -0.9995, -0.5, 0.0, 0.7, 0.9995, 1.0], np.float32)
    means = np.linspace(-1, 1, 7).astype(np.float32)
    log_scales = np.array([-7.0, -3.0, -1.0, 0.0, -5.0, -9.0, -2.0],
                          np.float32)
    want = jax_diffusion(None)._discretized_gaussian_log_likelihood(
        jnp.asarray(x), jnp.asarray(means), jnp.asarray(log_scales))
    got = create_diffusion(None)._discretized_gaussian_log_likelihood(
        *map(torch.from_numpy, (x, means, log_scales)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_uniform_sampler():
    t, w = UniformSampler(10).sample(torch.Generator().manual_seed(0), 500)
    assert t.min() >= 0 and t.max() <= 9 and len(set(t.tolist())) == 10
    assert torch.equal(w, torch.ones(500))


def test_loss_second_moment_resampler_matches_jax():
    T, H = 6, 3
    jr, tr = jax_ts.LossSecondMomentResampler(T, H, 0.01), \
        LossSecondMomentResampler(T, H, 0.01)
    js, ts = jr.init_state(), tr.init_state()
    rng = np.random.RandomState(0)
    for i in range(8):
        t = rng.permutation(T)[:4]  # distinct timesteps in one update
        losses = rng.rand(4).astype(np.float32) + i
        js = jr.update(js, jnp.asarray(t), jnp.asarray(losses))
        ts = tr.update(ts, torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
        np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
        np.testing.assert_allclose(tr.weights_from_state(ts).numpy(),
                                   np.asarray(jr.weights_from_state(js)),
                                   rtol=1e-6)
    assert (ts[1] >= H).all()  # warm: the weights left uniform
    p = tr.weights_from_state(ts)
    t, w = tr.sample(torch.Generator().manual_seed(1), 64, ts)
    np.testing.assert_allclose(w.numpy(), (1.0 / (T * p[t])).numpy(),
                               rtol=1e-6)
    # repeated timesteps in one update each bump the count
    ts2 = tr.update(ts, torch.tensor([2, 2, 2]), torch.ones(3))
    assert ts2[1][2] == ts[1][2] + 3


@pytest.mark.parametrize("n,world", [(1000, 1), (1000, 4), (100, 2)])
def test_ra_sampler_indices_match_jax(n, world):
    for rank in range(world):
        np.testing.assert_array_equal(
            ra_sampler_indices(n, rank, world, seed=3),
            jax_ra_indices(n, rank, world, seed=3))


def test_latent_npz_dataset_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "lat.npz")
    np.savez(path, latents=rng.randn(10, 4, 2, 2).astype(np.float32),
             labels=rng.randint(0, 5, 10))
    np.random.seed(7)
    want = [next(it) for it in [jax_datasets.latent_npz_dataset(path, 3)]
            for _ in range(5)]
    np.random.seed(7)
    it = datasets.latent_npz_dataset(path, 3)
    got = [next(it) for _ in range(5)]  # across a pass: 3 batches of 3
    for (gl, gy), (wl, wy) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("name", ["CIFAR10", "CIFAR100"])
@pytest.mark.parametrize("train", [False, True])
def test_build_dataset_cifar_matches_jax(tmp_path, name, train):
    rng = np.random.RandomState(1)

    def write(path, n, key):
        with open(path, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072),
                                              dtype=np.uint8),
                         key: list(rng.randint(0, 10, n))}, f)
    if name == "CIFAR100":
        os.makedirs(tmp_path / "cifar-100-python")
        for split in ("train", "test"):
            write(tmp_path / "cifar-100-python" / split, 7, b"fine_labels")
    else:
        os.makedirs(tmp_path / "cifar-10-batches-py")
        for fn in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            write(tmp_path / "cifar-10-batches-py" / fn, 3, b"labels")
    wit, wn = jax_datasets.build_dataset(name, str(tmp_path), train, 4)
    git, gn = datasets.build_dataset(name, str(tmp_path), train, 4)
    assert gn == wn
    want, got = list(wit), list(git)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError):
        datasets.build_dataset("MNIST", str(tmp_path))


def test_three_augment_matches_jax():
    from PIL import Image
    img = Image.fromarray(np.random.RandomState(2).randint(
        0, 256, (40, 48, 3), dtype=np.uint8))
    for seed in range(4):  # each of the three choices appears
        want = jax_augment.three_augment(img, np.random.RandomState(seed),
                                         img_size=24)
        got = augment.three_augment(img, np.random.RandomState(seed),
                                    img_size=24)
        assert got.shape == (3, 24, 24) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_save_load_params_round_trip(tmp_path):
    tree = {"model": {"w": torch.randn(3, 4), "b": torch.zeros(4)},
            "ema": [torch.arange(5.0), (torch.ones(2, dtype=torch.int64),)],
            "step": 7}
    path = str(tmp_path / "p.pkl")
    save_params(path, tree)
    back = load_params(path)
    assert back["step"] == 7
    np.testing.assert_array_equal(back["model"]["w"],
                                  tree["model"]["w"].numpy())
    np.testing.assert_array_equal(back["ema"][1][0], np.ones(2, np.int64))
    assert isinstance(back["ema"][1], tuple)


def test_dit_train_writes_checkpoints(tmp_path):
    """``train`` with ``ckpt_every``: the model's and the EMA's state dicts
    under JAX's names and step numbering; the loss is finite."""
    cfg = DiTConfig(input_size=4, hidden_size=32, depth=1, num_heads=2,
                    num_classes=4)
    rng = np.random.RandomState(0)
    data = [(rng.randn(2, 4, 4, 4).astype(np.float32),
             rng.randint(0, 4, 2)) for _ in range(3)]
    model, ema = dit_train.train(cfg, DiTQuantConfig(), iter(data), steps=2,
                                 ckpt_every=2, results_dir=str(tmp_path),
                                 log_every=1, device="cpu")
    ck = load_params(str(tmp_path / "0000002.pkl"))
    assert set(ck) == {"model", "ema"}
    assert set(ck["ema"]) == set(model.state_dict())
    np.testing.assert_array_equal(ck["model"]["blocks.0.attn.qkv.weight"],
                                  model.blocks[0].attn.qkv.weight.detach())
    assert not np.array_equal(ck["ema"]["pos_embed"],
                              ck["model"]["pos_embed"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dit_train.train(cfg, DiTQuantConfig(), iter(data), mesh=object(),
                        device="cpu")


def test_dit_train_cli_runs_on_the_cpu(capsys):
    model, ema = dit_train.main(["--device", "cpu", "--model", "DiT-debug",
                                 "--steps", "5", "--batch", "2",
                                 "--image-size", "32"])
    assert "step 5: loss" in capsys.readouterr().out
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_draw_timesteps_and_noise():
    """t, then the noise, from one generator (JAX's step splits one key
    the same way); a timestep sampler gives t and its weights."""
    x0 = torch.zeros(3, 4, 2, 2)
    t, noise, w = dit_train.draw_timesteps_and_noise(
        torch.Generator().manual_seed(0), x0, 1000)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(t, torch.randint(0, 1000, (3,), generator=g))
    assert torch.equal(noise, torch.randn(x0.shape, generator=g))
    assert w is None
    t2, _, w2 = dit_train.draw_timesteps_and_noise(
        torch.Generator().manual_seed(0), x0, 10, UniformSampler(10))
    assert t2.max() < 10 and torch.equal(w2, torch.ones(3))
