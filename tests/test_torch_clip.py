"""The port's CLIP (``models/clip.py``) against the JAX package's on the
CPU, at a tiny ``ClipConfig`` (image 28, patch 14, vision 64 wide with 2
layers and 2 heads, text 32 wide with 2 layers and 2 heads, projection
24), the weights from JAX's ``init_clip`` (scaled by 10 so that attention
is not uniform) carried over by ``clip_params_from_jax``: both towers
unquantized; each encoder layer with MX specs on JAX's layer input;
``preprocess_images``; the loader.

Tolerances: unquantized embeds within 2e-5 of their largest magnitude (f32
sums in another order than XLA's); an MX-quantized layer (MXINT8 block
32, the PixArt specs (flush, bfloat 32) and the DiT specs (bfloat 16)) at
most 1% of its outputs more than 1e-6 of the largest magnitude apart and
none more than one MX grid step (2^-6 of it) apart; the preprocessed
pixels within 1e-5 (the resize's 2e-6 over CLIP's std of ~0.27); the
loader equal, key for key.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.models.clip as jax_clip
from mx_quantization_tpu.workloads.dit import dit_mx_specs as jax_dit_specs
from mx_quantization_tpu.workloads.pixart import \
    pixart_mx_specs as jax_pixart_specs

from mx_quantization_tpu_torch.models import clip
from mx_quantization_tpu_torch.utils.checkpoint import clip_params_from_jax
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs
from mx_quantization_tpu_torch.workloads.pixart import pixart_mx_specs

TINY = dict(image_size=28, patch_size=14, v_hidden=64, v_layers=2,
            v_heads=2, v_mlp=128, vocab_size=100, max_positions=16,
            t_hidden=32, t_layers=2, t_heads=2, t_mlp=64, projection_dim=24)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_clip.ClipConfig(**TINY)
    params = jax.tree.map(lambda a: np.asarray(a) * 10 if a.ndim == 2 else
                          np.asarray(a),
                          jax_clip.init_clip(jax.random.key(0), jcfg))
    model = clip_params_from_jax(params, clip.ClipConfig(**TINY), "cpu")
    return jcfg, params, model


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _ids(seed, eos):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 90, (3, 16))
    mask = np.zeros((3, 16), np.int32)
    for i, n in enumerate((16, 9, 4)):
        ids[i, n - 1] = eos
        ids[i, n:] = 0
        mask[i, :n] = 1
    return ids, mask


def test_image_tower_matches_jax(tiny):
    jcfg, params, model = tiny
    px = np.random.RandomState(1).randn(2, 3, 28, 28).astype(np.float32)
    got = clip.clip_image_embed(model, torch.from_numpy(px))
    assert got.shape == (2, 24)
    _close(got, jax_clip.clip_image_embed(jax.tree.map(jnp.asarray, params),
                                          jnp.asarray(px), jcfg))


@pytest.mark.parametrize("eos", [2, 99])
def test_text_tower_matches_jax(tiny, eos):
    """The legacy config pools at the highest id (the eot token is 99
    there); another eos id pools at its first occurrence."""
    jcfg, params, model = tiny
    jcfg = dataclasses.replace(jcfg, eos_token_id=eos)
    model.cfg = dataclasses.replace(model.cfg, eos_token_id=eos)
    ids, mask = _ids(2, 99)
    got = clip.clip_text_embed(model, torch.from_numpy(ids),
                               torch.from_numpy(mask))
    want = jax_clip.clip_text_embed(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(ids), jcfg,
                                    attention_mask=jnp.asarray(mask))
    model.cfg = clip.ClipConfig(**TINY)
    assert got.shape == (3, 24)
    _close(got, want)


@pytest.mark.parametrize("specs", ["pixart", "dit"])
@pytest.mark.parametrize("tower", ["vision", "text"])
def test_mx_layers_match_jax(tiny, specs, tower):
    jcfg, params, model = tiny
    pspecs, jspecs = {"pixart": (pixart_mx_specs(), jax_pixart_specs()),
                      "dit": (dit_mx_specs(), jax_dit_specs())}[specs]
    heads = jcfg.v_heads if tower == "vision" else jcfg.t_heads
    width = jcfg.v_hidden if tower == "vision" else jcfg.t_hidden
    x = np.random.RandomState(3).randn(2, 16, width).astype(np.float32)
    mask = None
    if tower == "text":
        causal = np.where(np.arange(16)[:, None] >= np.arange(16)[None],
                          0.0, np.finfo(np.float32).min).astype(np.float32)
        mask = causal[None, None]
    for i, lp in enumerate(getattr(model, tower).layers):
        jp = jax.tree.map(jnp.asarray, params[tower]["layers"][i])
        want = np.asarray(jax_clip._encoder_layer(
            jp, jnp.asarray(x), heads, jcfg.eps,
            None if mask is None else jnp.asarray(mask), jspecs))
        with torch.inference_mode():
            got = clip._encoder_layer(
                lp, torch.from_numpy(x), heads, jcfg.eps,
                None if mask is None else torch.from_numpy(mask),
                pspecs).numpy()
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        assert (diff > 1e-6 * scale).mean() <= 0.01, i
        assert diff.max() <= 2.0 ** -6 * scale, i
        x = want


def test_mx_towers_run(tiny):
    """Both towers end to end with the PixArt specs: finite, and near the
    unquantized embeds."""
    _, _, model = tiny
    px = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 28, 28)
                          .astype(np.float32))
    ids, mask = map(torch.from_numpy, _ids(5, 99))
    for fn, args in ((clip.clip_image_embed, (px,)),
                     (clip.clip_text_embed, (ids, mask))):
        q = fn(model, *args, mx_specs=pixart_mx_specs())
        f = fn(model, *args)
        assert torch.isfinite(q).all()
        assert torch.allclose(q, f, rtol=0, atol=0.1 * f.abs().max())


def test_preprocess_matches_jax():
    cfg = clip.ClipConfig()
    rng = np.random.RandomState(6)
    for shape in ((2, 40, 30, 3), (1, 30, 50, 3), (1, 512, 512, 3)):
        imgs = rng.randint(0, 256, shape).astype(np.uint8)
        got = clip.preprocess_images(imgs, cfg, "cpu")
        want = jax_clip.preprocess_images(imgs, cfg)
        assert got.shape == want.shape == (shape[0], 3, 224, 224)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_loader_matches_jax(tiny, tmp_path):
    jcfg, params, model = tiny
    sd = model.state_dict()
    hf = {theirs: sd[ours].clone() for ours, theirs
          in clip.clip_checkpoint_names(model.cfg).items()}
    path = tmp_path / "clip.bin"
    torch.save(hf, path)
    for src in (hf, str(path)):
        got = clip.load_clip_checkpoint(src, model.cfg)
        want = jax_clip.load_clip_checkpoint(src, jcfg)
        assert set(got) == set(sd)
        for name, value in got.items():
            node = want
            for key in name.split("."):
                node = node[int(key)] if isinstance(node, list) \
                    else node[key]
            np.testing.assert_array_equal(value.numpy(), node,
                                          err_msg=name)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip.Clip(clip.ClipConfig(**TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip.preprocess_images(np.zeros((1, 8, 8, 3), np.uint8),
                               clip.ClipConfig())
