"""The port's native ImageNet loader (``native/``: the C++ decoder built
with g++ and libjpeg, its double-buffered iterator) and the DeiT loader's
position-table resize, against the JAX package's.

  * ``decode_batch`` bit-equal to the JAX package's built loader
    (``mx_quantization_tpu.native.dataloader.decode_batch``) on synthetic
    JPEGs that PIL writes, of several sizes (down and up, both
    orientations), with a missing file flagged ok = 0 on both sides.
  * ``iterate_imagenet(native=True)`` takes the native path here (its
    batches bit-equal to JAX's built loader's, unlike PIL's) and gives
    JAX's batches and labels; ``native=False`` JAX's PIL path; a loader
    that cannot be built falls back to PIL, as JAX's does; and
    ``imagenet_val_batches`` defaults to the native loader, as JAX's does.
  * ``interpolate_pos_embed`` against JAX's (``jax.image.resize``'s
    bicubic) on (1, 197, 192) tables resized to 576 and 144 patches, within
    tests/test_torch_resize.py's 2e-6 on [0, 1) data; the class token's row
    unchanged; ``load_deit_checkpoint(interpolate_pos_embed_to=)`` on a
    test-written state dict.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from mx_quantization_tpu.data import imagenet as jax_imagenet
from mx_quantization_tpu.native import dataloader as jax_loader
from mx_quantization_tpu.utils import checkpoint as jax_checkpoint

from mx_quantization_tpu_torch.data import imagenet
from mx_quantization_tpu_torch.native import dataloader as loader
from mx_quantization_tpu_torch.utils.checkpoint import (interpolate_pos_embed,
                                                        load_deit_checkpoint)
from mx_quantization_tpu_torch.workloads import deit
from test_native_dataloader import _write_jpegs

SIZES = [(300, 240), (256, 256), (180, 420), (96, 130), (640, 480)]


def test_decode_batch_bit_equal_to_jax(tmp_path):
    paths = _write_jpegs(tmp_path, SIZES)
    paths.append(os.path.join(str(tmp_path), "missing.jpg"))
    for size in (224, 64):
        got, ok = loader.decode_batch(paths, img_size=size)
        want, want_ok = jax_loader.decode_batch(paths, img_size=size)
        assert got.shape == (len(paths), 3, size, size)
        np.testing.assert_array_equal(ok, want_ok)
        assert ok.tolist() == [1] * len(SIZES) + [0]
        np.testing.assert_array_equal(got, want)
    # the build went into the port's own directory
    assert loader.load.__module__.startswith("mx_quantization_tpu_torch")
    from mx_quantization_tpu_torch.native import build
    assert build.library_path("mxdataloader", "dataloader.cpp",
                              ("jpeg",)).exists()


@pytest.fixture
def jpeg_tree(tmp_path):
    """val/<wnid>/*.JPEG, three classes, sizes varying."""
    root = tmp_path / "val"
    for c, wnid in enumerate(("n03", "n01", "n02")):
        (root / wnid).mkdir(parents=True)
        for i, p in enumerate(_write_jpegs(tmp_path, SIZES[c:c + 3])):
            os.replace(p, root / wnid / f"img_{i}.JPEG")
    return str(root)


def _batches(module, root, native):
    return list(module.iterate_imagenet(root, batch_size=4, img_size=48,
                                        native=native))


def _assert_same(got, want):
    assert len(got) == len(want) == 3  # 9 images in batches of 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == np.float32 and gy.dtype == np.int64
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _assert_path(got, root, native):
    """``got`` is bit-equal to JAX's batches of the path ``native`` names
    and differs from the other path's (the native loader resizes
    bilinearly, PIL bicubically), so it can only have come from that path;
    JAX's native batches are its built loader's (``decode_batch``)."""
    want, other = (_batches(jax_imagenet, root, n) for n in (native,
                                                              not native))
    jax_native = want if native else other
    paths, _ = imagenet.list_imagenet(root)
    np.testing.assert_array_equal(
        jax_native[0][0], jax_loader.decode_batch(paths[:4], 48)[0])
    _assert_same(got, want)
    assert not np.array_equal(got[0][0], other[0][0])


def test_iterate_native_matches_jax(jpeg_tree):
    _assert_path(_batches(imagenet, jpeg_tree, True), jpeg_tree, True)


def test_iterate_pil_matches_jax(jpeg_tree):
    _assert_path(_batches(imagenet, jpeg_tree, False), jpeg_tree, False)


def test_native_falls_back_to_pil(jpeg_tree, monkeypatch, capsys):
    def no_compiler():
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(loader, "load", no_compiler)
    _assert_path(_batches(imagenet, jpeg_tree, True), jpeg_tree, False)
    assert "decoding with PIL" in capsys.readouterr().err


def test_val_batches_default_to_the_native_loader(jpeg_tree):
    default = inspect.signature(deit.imagenet_val_batches).parameters[
        "native"].default
    assert default is True
    _assert_path(list(deit.imagenet_val_batches(jpeg_tree, 4, 48)),
                 jpeg_tree, True)


@pytest.mark.parametrize("patches", [576, 144])
def test_interpolate_pos_embed_matches_jax(patches):
    table = np.random.RandomState(patches).rand(1, 197, 192).astype(
        np.float32)
    got = interpolate_pos_embed(torch.from_numpy(table), patches).numpy()
    want = jax_checkpoint.interpolate_pos_embed(table, patches)
    assert got.shape == want.shape == (1, 1 + patches, 192)
    np.testing.assert_array_equal(got[:, 0], table[:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_load_deit_checkpoint_resizes_the_position_table(tmp_path):
    """A depth-1 timm state dict written here (under "model", as DeiT's
    releases keep it), read at 24^2 = 576 patches."""
    rng = np.random.RandomState(3)
    E = 64
    shapes = {"patch_embed.proj.weight": (E, 3, 16, 16),
              "patch_embed.proj.bias": (E,), "cls_token": (1, 1, E),
              "pos_embed": (1, 197, E), "norm.weight": (E,),
              "norm.bias": (E,), "head.weight": (10, E), "head.bias": (10,)}
    for mod, shape in (("norm1", (E,)), ("attn.qkv", (3 * E, E)),
                       ("attn.proj", (E, E)), ("norm2", (E,)),
                       ("mlp.fc1", (4 * E, E)), ("mlp.fc2", (E, 4 * E))):
        shapes[f"blocks.0.{mod}.weight"] = shape
        shapes[f"blocks.0.{mod}.bias"] = shape[:1]
    sd = {k: torch.from_numpy(rng.rand(*s).astype(np.float32))
          for k, s in shapes.items()}
    path = str(tmp_path / "deit.pth")
    torch.save({"model": sd}, path)

    plain = load_deit_checkpoint(path, depth=1)
    got = load_deit_checkpoint(path, depth=1, interpolate_pos_embed_to=576)
    assert torch.equal(plain["pos_embed"], sd["pos_embed"])
    assert got["pos_embed"].shape == (1, 577, E)
    assert torch.equal(got["pos_embed"],
                       interpolate_pos_embed(sd["pos_embed"], 576))
    assert all(torch.equal(got[k], plain[k]) for k in plain
               if k != "pos_embed")
    want = jax_checkpoint.load_deit_checkpoint(
        path, depth=1, interpolate_pos_embed_to=576)["pos_embed"]
    np.testing.assert_allclose(got["pos_embed"].numpy(), want, rtol=0,
                               atol=2e-6)
