"""The port's AutoencoderKL (``models/vae.py``) against the JAX package's
on the CPU: decode and encode (the mode) on a narrow tree the test builds
(block channels 32 and 64, two up and two down blocks, GroupNorm(32)), the
loader at sd-vae-ft-mse's full widths on a state dict with diffusers'
names, a full-width decode of a 4 x 4 latent, and the DiT and PixArt CLIs'
``--vae``.

Tolerances: decode and encode within 2e-5 of the output's largest
magnitude (f32 convs and GroupNorm sums in another order than XLA's,
through a dozen resnets and the mid attention); the loader equal, key for
key; GroupNorm's two-pass variance against ``F.group_norm`` within 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import mx_quantization_tpu.models.vae as jax_vae

from mx_quantization_tpu_torch.models import vae
from mx_quantization_tpu_torch.utils.checkpoint import vae_params_from_jax
from mx_quantization_tpu_torch.workloads import dit as port_dit
from mx_quantization_tpu_torch.workloads import pixart as port_pixart

NARROW = vae.VaeConfig(block_ch=(32, 64))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(sd):
    """A state dict in the port's names as a JAX parameter tree (nested
    dicts; lists where the keys are indices)."""
    tree = {}
    for name, value in sd.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return listify(tree)


@pytest.fixture(scope="module")
def narrow():
    model = vae.init_vae(NARROW, torch.Generator().manual_seed(0), "cpu")
    tree = _tree(model.state_dict())
    port = vae_params_from_jax(tree, NARROW, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    return port, jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def full_checkpoint(tmp_path_factory):
    """A random sd-vae-ft-mse state dict at full widths, diffusers' names."""
    model = vae.init_vae(vae.VaeConfig(), torch.Generator().manual_seed(1),
                         "cpu")
    sd = model.state_dict()
    path = tmp_path_factory.mktemp("vae") / "vae.bin"
    torch.save({theirs: sd[ours] for ours, theirs
                in vae.vae_checkpoint_names().items()}, path)
    return str(path), model


def _close(got, want, rel=2e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=rel * np.abs(np.asarray(want)).max())


def test_decode_matches_jax(narrow):
    model, tree = narrow
    z = np.random.RandomState(0).randn(2, 4, 6, 5).astype(np.float32)
    got = vae.decode_latents(model, torch.from_numpy(z))
    assert got.shape == (2, 3, 12, 10)
    _close(got, jax_vae.decode_latents(tree, jnp.asarray(z)))
    _close(vae.decode_latents(model, torch.from_numpy(z), scale=False),
           jax_vae.decode_latents(tree, jnp.asarray(z), scale=False))


def test_encode_matches_jax(narrow):
    model, tree = narrow
    x = np.random.RandomState(1).uniform(-1, 1, (2, 3, 16, 12)).astype(
        np.float32)
    got = vae.encode_images(model, torch.from_numpy(x))
    assert got.shape == (2, 4, 8, 6)
    _close(got, jax_vae.encode_images(tree, jnp.asarray(x)))
    # a sample from the latent distribution: the mode plus std * noise
    g = torch.Generator().manual_seed(3)
    sampled = vae.encode_images(model, torch.from_numpy(x), generator=g)
    assert sampled.shape == got.shape and torch.isfinite(sampled).all()
    assert not torch.equal(sampled, got)


def test_group_norm_equals_two_pass_and_library():
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 5, 7)
                         .astype(np.float32) * 3 + 1)
    p = torch.nn.Module()
    p.weight = torch.nn.Parameter(torch.linspace(0.5, 1.5, 64))
    p.bias = torch.nn.Parameter(torch.linspace(-1, 1, 64))
    got = vae._gn(x, p)
    want = jax_vae._gn(jnp.asarray(x.numpy()), jnp.asarray(p.weight.detach()),
                       jnp.asarray(p.bias.detach()))
    _close(got.detach(), want, 1e-6)
    lib = F.group_norm(x, 32, p.weight, p.bias, eps=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), lib.detach().numpy(),
                               rtol=0, atol=1e-5)


def test_loader_full_width_matches_jax(full_checkpoint):
    path, model = full_checkpoint
    got = vae.load_vae_checkpoint(path)
    want = jax_vae.load_vae_checkpoint(path)
    assert set(got) == set(model.state_dict())
    for name, value in got.items():
        node = want
        for key in name.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        np.testing.assert_array_equal(value.numpy(), node, err_msg=name)
    full = vae.AutoencoderKL(device="cpu")
    full.load_state_dict(got)
    z = np.random.RandomState(3).randn(1, 4, 4, 4).astype(np.float32)
    out = vae.decode_latents(full, torch.from_numpy(z))
    assert out.shape == (1, 3, 32, 32)
    _close(out, jax_vae.decode_latents(jax.tree.map(jnp.asarray, want),
                                       jnp.asarray(z)))


def test_dit_cli_vae(full_checkpoint, tmp_path):
    out = tmp_path / "dit.npz"
    port_dit.main(["--device", "cpu", "--model", "DiT-debug",
                   "--image-size", "32", "--num-classes", "10",
                   "--classes", "1", "3", "--num-steps", "2",
                   "--vae", full_checkpoint[0], "--out", str(out)])
    z = np.load(out)
    assert z["latents"].shape == (2, 4, 4, 4)
    assert z["samples"].shape == (2, 3, 32, 32)
    assert np.isfinite(z["samples"]).all()


def test_pixart_cli_vae(full_checkpoint, tmp_path):
    out = tmp_path / "pixart.npz"
    port_pixart.main(["--device", "cpu", "--num-layers", "2",
                      "--num-heads", "2", "--caption-channels", "32",
                      "--image-size", "32", "--max-token-length", "8",
                      "--num-steps", "2", "--prompts", "a",
                      "--vae", full_checkpoint[0], "--out", str(out)])
    z = np.load(out)
    assert z["latents"].shape == (1, 4, 4, 4)
    assert z["samples"].shape == (1, 3, 32, 32)
    assert np.isfinite(z["samples"]).all()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vae.AutoencoderKL(NARROW)
