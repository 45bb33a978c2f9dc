"""The port's ``workloads/accuracy.py`` on the CPU at tiny models, against
the JAX package where the two can see the same data.

  * Its parser has JAX's subcommands and options with JAX's defaults; the
    port adds ``--device`` and names ``--clip-backend``'s choices after
    its own towers ("port", "transformers" for JAX's "jax", "torch").
  * ``dit``: DiT-debug at 32^2, 4 samples in batches of 2, 2 steps,
    random weights (the CLI warns), decoded by a test-written full-width
    VAE, the FID step against a reference feature npz with a test-written
    pt_inception (the report's metric math is held to JAX's on feature
    npzs in ``tests/test_torch_eval.py``; here the FID step is fed the
    generated images' features).
  * ``pixart``: a tiny PixArt (2 layers, 2 heads, captions 32 wide) at
    64^2 on a test-written embeds npz with prompts, decoded by the VAE,
    scored by the port's CLIP towers from a folder read through a
    transformers stub (a tiny CLIPModel's state dict and config; the
    tokenizer a stub too: the repository holds no CLIP files).  The score
    equals JAX's ``clip_score_jax`` on the same images within 1e-4
    (f32 towers summed in another order).
  * ``deit``: DeiT's ``main`` at a tiny config through the subcommand.
"""

import functools
import json
import sys
import types

import numpy as np
import pytest
import torch

import jax

import mx_quantization_tpu.evaluation.clip_score as jax_clip_score
import mx_quantization_tpu.models.clip as jax_clip
import mx_quantization_tpu.workloads.accuracy as jax_accuracy

import mx_quantization_tpu_torch.models.pixart as port_pixart_models
from chip_smoke import random_pt_inception
from mx_quantization_tpu_torch.evaluation import run_eval
from mx_quantization_tpu_torch.models import clip
from mx_quantization_tpu_torch.models.vae import (VaeConfig, init_vae,
                                                  vae_checkpoint_names)
from mx_quantization_tpu_torch.models.vit import VIT_CONFIGS, VitConfig
from mx_quantization_tpu_torch.utils.checkpoint import clip_params_from_jax
from mx_quantization_tpu_torch.workloads import accuracy

CLIP_TINY = dict(image_size=28, patch_size=14, v_hidden=64, v_layers=2,
                 v_heads=2, v_mlp=128, vocab_size=100, max_positions=16,
                 t_hidden=32, t_layers=2, t_heads=2, t_mlp=64,
                 projection_dim=24, eos_token_id=99)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A full-width VAE (diffusers' names), a pt_inception state dict and
    a reference feature npz, written as the public files would be."""
    root = tmp_path_factory.mktemp("assets")
    sd = init_vae(VaeConfig(), torch.Generator().manual_seed(0),
                  "cpu").state_dict()
    torch.save({theirs: sd[ours]
                for ours, theirs in vae_checkpoint_names().items()},
               root / "vae.bin")
    torch.save(random_pt_inception(1), root / "inception.pth")
    rng = np.random.RandomState(0)
    logits = rng.randn(12, 1008)
    np.savez(root / "ref.npz",
             pool3=rng.rand(12, 2048).astype(np.float32),
             spatial=rng.rand(12, 7 * 17 * 17).astype(np.float32),
             pred=(np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
             .astype(np.float32))
    return {k: str(root / f) for k, f in (("vae", "vae.bin"),
                                          ("inception", "inception.pth"),
                                          ("ref", "ref.npz"))}


def _options(parser):
    subs = next(a for a in parser._actions
                if isinstance(a, type(parser._subparsers._group_actions[0])))
    return {name: {a.option_strings[-1]: (a.default, a.choices, a.nargs,
                                          a.type)
                   for a in sub._actions if a.dest != "help"}
            for name, sub in subs.choices.items()}


def test_parser_matches_jax():
    want = _options(jax_accuracy.build_argparser())
    got = _options(accuracy.build_argparser())
    assert set(got) == set(want) == {"deit", "dit", "pixart"}
    for name in want:
        assert set(got[name]) - set(want[name]) == {"--device"}
        for opt, spec in want[name].items():
            if opt == "--clip-backend":
                assert got[name][opt][1] == ["port", "transformers"]
                continue
            assert got[name][opt] == spec, (name, opt)


def test_dit_fid_path(assets, tmp_path, monkeypatch, capsys):
    """Four samples: the Inception Score's ten splits leave some empty, so
    it is NaN here, in both packages."""
    seen = []
    report_fn = run_eval.full_report

    def spy(*feats):
        seen.append(feats)
        return report_fn(*feats)

    monkeypatch.setattr(run_eval, "full_report", spy)
    out = str(tmp_path / "dit.npz")
    report = accuracy.main([
        "dit", "--device", "cpu", "--model", "DiT-debug", "--image-size",
        "32", "--num-samples", "4", "--batch", "2", "--num-steps", "2",
        "--k", "6", "--vae", assets["vae"], "--ref", assets["ref"],
        "--inception", assets["inception"], "--out", out])
    printed = capsys.readouterr().out
    assert "random weights" in printed
    assert set(report) == {"fid", "sfid", "inception_score", "precision",
                           "recall"}
    np.testing.assert_equal(json.loads(printed.strip().splitlines()[-1]),
                            {"workload": "dit", **report})
    imgs = np.load(out)["arr_0"]
    assert imgs.shape == (4, 32, 32, 3) and imgs.dtype == np.uint8
    assert np.isfinite([report[k] for k in report
                        if k != "inception_score"]).all()
    # the FID step saw the generated images' Inception features; the
    # metric math on them is JAX's, equal (tests/test_torch_eval.py: the
    # same feature npzs through both run_eval CLIs)
    (ref_pool, gen_pool, ref_sp, gen_sp, gen_pred), = seen
    assert gen_pool.shape == (4, 2048) and gen_sp.shape == (4, 2023)
    np.testing.assert_array_equal(ref_pool, np.load(assets["ref"])["pool3"])


def _hf_clip_stub(cfg, params):
    """A transformers stand-in whose CLIPModel.from_pretrained gives a
    tiny CLIP's state dict (transformers' names) and config, and whose
    CLIPTokenizer gives ids ending in the eos token 99."""
    model = clip_params_from_jax(params, cfg, "cpu")
    sd = {theirs: model.state_dict()[ours]
          for ours, theirs in clip.clip_checkpoint_names(cfg).items()}
    hf_cfg = types.SimpleNamespace(
        projection_dim=cfg.projection_dim,
        vision_config=types.SimpleNamespace(
            image_size=cfg.image_size, patch_size=cfg.patch_size,
            hidden_size=cfg.v_hidden, num_hidden_layers=cfg.v_layers,
            num_attention_heads=cfg.v_heads,
            intermediate_size=cfg.v_mlp),
        text_config=types.SimpleNamespace(
            vocab_size=cfg.vocab_size,
            max_position_embeddings=cfg.max_positions,
            hidden_size=cfg.t_hidden, num_hidden_layers=cfg.t_layers,
            num_attention_heads=cfg.t_heads, intermediate_size=cfg.t_mlp,
            eos_token_id=cfg.eos_token_id))
    hf_model = types.SimpleNamespace(config=hf_cfg, state_dict=lambda: sd)

    def tokenize(texts, padding, truncation, max_length, return_tensors):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            n = min(max_length, 2 + len(t))
            ids[i, :n] = (np.arange(n) * 11 + i + 3) % 90 + 3
            ids[i, n - 1] = 99
            mask[i, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}

    stub = types.ModuleType("transformers")
    stub.CLIPModel = types.SimpleNamespace(
        from_pretrained=lambda path, **kw: hf_model)
    stub.CLIPTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path, **kw: tokenize)
    return stub


def test_pixart_clip_path(assets, tmp_path, monkeypatch, capsys):
    tiny = functools.partial(port_pixart_models.PixArtConfig, num_layers=2,
                             num_attention_heads=2, caption_channels=32)
    monkeypatch.setattr(port_pixart_models, "PixArtConfig", tiny)
    rng = np.random.RandomState(1)
    embeds = rng.randn(3, 8, 32).astype(np.float32)
    mask = (np.arange(8)[None] < np.array([[8], [5], [2]])).astype(np.int32)
    np.savez(tmp_path / "embeds.npz", embeds=embeds, mask=mask,
             null_embeds=rng.randn(1, 8, 32).astype(np.float32),
             prompts=np.array(["a red bus", "two dogs", "tea"]))
    jcfg = jax_clip.ClipConfig(**CLIP_TINY)
    params = jax.tree.map(np.asarray,
                          jax_clip.init_clip(jax.random.key(0), jcfg))
    monkeypatch.setitem(sys.modules, "transformers", _hf_clip_stub(
        clip.ClipConfig(**CLIP_TINY), params))
    out = str(tmp_path / "pixart.npz")
    report = accuracy.main([
        "pixart", "--device", "cpu", "--image-size", "64",
        "--prompt-embeds", str(tmp_path / "embeds.npz"), "--batch", "2",
        "--num-steps", "2", "--self-k", "6", "--vae", assets["vae"],
        "--clip", "clip-folder", "--out", out])
    assert "random weights" in capsys.readouterr().out
    imgs = np.load(out)["arr_0"]
    assert imgs.shape == (3, 64, 64, 3) and imgs.dtype == np.uint8
    assert report["samples"] == 3 and 0 <= report["clip_score"] <= 100
    want = jax_clip_score.clip_score_jax(
        imgs, ["a red bus", "two dogs", "tea"], "clip-folder")
    assert report["clip_score"] == pytest.approx(want, rel=1e-4, abs=1e-4)


def test_deit_subcommand(monkeypatch):
    monkeypatch.setitem(VIT_CONFIGS, "deit_tiny_patch16_224", VitConfig(
        img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
        num_heads=2))
    stats = accuracy.main(["deit", "--device", "cpu", "--batch", "3",
                           "--k", "6"])
    assert stats["n"] == 3 and 0 <= stats["acc1"] <= stats["acc5"] <= 1


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy.main(["dit", "--model", "DiT-debug"])
    np.savez(tmp_path / "e.npz", embeds=np.zeros((1, 4, 8), np.float32),
             mask=np.ones((1, 4), np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy.main(["pixart", "--prompt-embeds", str(tmp_path / "e.npz")])
