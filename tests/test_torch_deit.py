"""The port's DeiT evaluation workload (``workloads/deit.py``) and ImageNet
pipeline (``data/imagenet.py``) against the JAX package's: the accuracy
counts, ``evaluate``'s device-side counters, the CLI on a tiny model on the
CPU (and the options it cannot serve yet, which raise), the folder listing
and the PIL decode bit for bit, and the entry points' default device."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu.data import imagenet as jax_imagenet
from mx_quantization_tpu.workloads.deit import \
    accuracy_counts as jax_accuracy_counts
from mx_quantization_tpu.workloads.deit import \
    default_mx_specs as jax_specs

from mx_quantization_tpu_torch.data import imagenet
from mx_quantization_tpu_torch.models.vit import (VIT_CONFIGS, ViT, VitConfig,
                                                  VitQuantConfig, init_vit,
                                                  vit_forward)
from mx_quantization_tpu_torch.workloads import deit
from test_torch_dit512 import _one_torch_thread  # noqa: F401


TINY = VitConfig(img_size=32, patch_size=8, num_classes=10, embed_dim=64,
                 depth=2, num_heads=2)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")


def test_default_specs_match_jax():
    assert deit.default_mx_specs().to_dict() == jax_specs().to_dict()


def test_accuracy_counts_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(64, 1000).astype(np.float32)  # no ties
    labels = rng.randint(0, 1000, 64)
    top5 = np.argsort(-logits, axis=1)[:, :5]
    labels[:20] = top5[:20, 0]  # some top-1 hits
    labels[20:30] = top5[20:30, 3]  # some top-5 hits
    got = deit.accuracy_counts(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    want = jax_accuracy_counts(jnp.asarray(logits), jnp.asarray(labels))
    assert [int(g) for g in got] == [int(w) for w in want] == [20, 30]


def test_evaluate_counts_on_the_device_and_matches_the_forward():
    model = init_vit(TINY, torch.Generator().manual_seed(0), "cpu")
    qcfg = VitQuantConfig(mx_specs=deit.default_mx_specs(), mx_quant=True,
                          k=6)
    rng = np.random.RandomState(1)
    batches = [(rng.randn(3, 3, 32, 32).astype(np.float32),
                rng.randint(0, 10, 3)) for _ in range(2)]
    c1 = c5 = 0
    for x, y in batches:
        logits = vit_forward(model, torch.from_numpy(x), qcfg)
        b1, b5 = deit.accuracy_counts(logits, torch.from_numpy(y))
        c1, c5 = c1 + int(b1), c5 + int(b5)
    stats = deit.evaluate(model, qcfg, iter(batches), device="cpu",
                          log_every=1)
    assert stats == {"acc1": c1 / 6, "acc5": c5 / 6, "n": 6}


def test_cli_runs_a_tiny_model_on_the_cpu(monkeypatch, capsys):
    """``main`` end to end at a tiny size (the CLI's model names map to
    the tiny config): random weights, one synthetic batch, the DeiT specs
    and routes, the emulation engine (``--engine ref``) and the gathered
    attention (``--sparse-impl gather``); then the option the port cannot
    serve, raising with a pointer to ROADMAP.md."""
    monkeypatch.setitem(VIT_CONFIGS, "deit_tiny_patch16_224", TINY)
    base = ["--device", "cpu", "--batch-size", "3", "--mx-quant"]
    for extra in (["--top-k", "--k", "6"],
                  ["--top-k", "--k", "6", "--pred-mode",
                   "two_step_leading_ones", "--contract", "serving"],
                  ["--top-k", "--k", "6", "--no-approx",
                   "--exclude-blocks", "0",
                   "--exclude-block-type", "two_step_leading_ones"],
                  ["--top-k", "--k", "6", "--engine", "ref"],
                  ["--top-k", "--k", "6", "--sparse-impl", "gather"]):
        stats = deit.main(base + extra)
        assert stats["n"] == 3 and 0 <= stats["acc1"] <= stats["acc5"] <= 1
    assert '"n": 3' in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deit.main(base + ["--anal"])


def test_cli_loads_a_checkpoint(monkeypatch, tmp_path):
    """``--checkpoint``: a timm-style state dict under 'model' through
    ``load_deit_checkpoint`` into the model the CLI evaluates."""
    model = init_vit(TINY, torch.Generator().manual_seed(3), "cpu")
    sd = {k.replace("patch_embed.", "patch_embed.proj."): v
          for k, v in model.state_dict().items()}
    path = tmp_path / "deit.pth"
    torch.save({"model": sd}, path)
    monkeypatch.setitem(VIT_CONFIGS, "deit_tiny_patch16_224", TINY)
    seen = {}

    def spy(m, *args, **kw):
        seen["sd"] = m.state_dict()
        return {"acc1": 0.0, "acc5": 0.0, "n": 0}

    monkeypatch.setattr(deit, "evaluate", spy)
    deit.main(["--device", "cpu", "--checkpoint", str(path)])
    for k, v in model.state_dict().items():
        assert torch.equal(seen["sd"][k], v), k


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViT(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_vit(TINY, torch.Generator())
    model = init_vit(TINY, torch.Generator(), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deit.evaluate(model, VitQuantConfig(), iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deit.main([])


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """A class-folder tree of PNGs of several sizes and aspect ratios."""
    pil = pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("val")
    rng = np.random.RandomState(0)
    sizes = [(40, 30), (30, 44), (37, 37), (64, 33), (33, 50)]
    for c, wnid in enumerate(("n02", "n01", "n10")):
        (root / wnid).mkdir()
        for i in range(3):
            w, h = sizes[(c + i) % len(sizes)]
            arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            pil.fromarray(arr).save(root / wnid / f"img_{i}.png")
        (root / wnid / "notes.txt").write_text("not an image")
    return str(root)


def test_imagenet_listing_matches_jax(image_tree):
    assert imagenet.list_imagenet(image_tree) == \
        jax_imagenet.list_imagenet(image_tree)


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_imagenet_batches_match_jax(image_tree, shard):
    kw = dict(batch_size=2, img_size=24, limit=4, native=False, shard=shard)
    got = list(imagenet.iterate_imagenet(image_tree, **kw))
    want = list(jax_imagenet.iterate_imagenet(image_tree, **kw))
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == np.float32 and gx.shape[1:] == (3, 24, 24)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(imagenet.iterate_imagenet(image_tree, native=True))


def test_val_batches_feed_evaluate(image_tree):
    """``imagenet_val_batches`` (PIL decode) through ``evaluate``."""
    cfg = VitConfig(img_size=24, patch_size=8, num_classes=10, embed_dim=64,
                    depth=1, num_heads=2)
    model = init_vit(cfg, torch.Generator().manual_seed(0), "cpu")
    stats = deit.evaluate(
        model, VitQuantConfig(mx_specs=deit.default_mx_specs(),
                              mx_quant=True, k=4),
        deit.imagenet_val_batches(image_tree, 4, 24), device="cpu")
    assert stats["n"] == 9
