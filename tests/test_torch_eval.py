"""The port's metric math (``evaluation/fid.py``), npz packers
(``evaluation/npz_io.py``), CLIP score from features and the ``run_eval``
CLI against the JAX package's, on synthetic features.  Every function is
numpy and scipy on the host in both packages, so the results are equal,
not close.
"""

import json

import numpy as np
import pytest

import mx_quantization_tpu.evaluation.clip_score as jax_clip_score
import mx_quantization_tpu.evaluation.fid as jax_fid
import mx_quantization_tpu.evaluation.npz_io as jax_npz
import mx_quantization_tpu.evaluation.run_eval as jax_run_eval

from mx_quantization_tpu_torch.evaluation import (clip_score, fid, npz_io,
                                                  run_eval)


def _features(seed, n=64, shift=0.0):
    rng = np.random.RandomState(seed)
    pool3 = (rng.randn(n, 48) + shift).astype(np.float32)
    spatial = (rng.randn(n, 21) * 2 + shift).astype(np.float32)
    logits = rng.randn(n, 10).astype(np.float32) * 3
    pred = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return {"pool3": pool3, "spatial": spatial, "pred": pred}


@pytest.mark.parametrize("n_ref,n_gen,shift", [(64, 64, 0.0), (80, 50, 0.3),
                                               (20, 30, 1.0)])
def test_full_report_equals_jax(n_ref, n_gen, shift):
    ref, gen = _features(0, n_ref), _features(1, n_gen, shift)
    args = (ref["pool3"], gen["pool3"], ref["spatial"], gen["spatial"],
            gen["pred"])
    got = fid.full_report(*args)
    assert got == jax_fid.full_report(*args)
    assert set(got) == {"fid", "sfid", "inception_score", "precision",
                        "recall"}


def test_pieces_equal_jax():
    a, b = _features(2)["pool3"], _features(3, shift=0.5)["pool3"]
    for g, j in zip(fid.compute_statistics(a),
                    jax_fid.compute_statistics(a)):
        np.testing.assert_array_equal(g, j)
    assert fid.compute_fid(a, b) == jax_fid.compute_fid(a, b)
    p = _features(4)["pred"]
    assert fid.compute_inception_score(p, 4) == \
        jax_fid.compute_inception_score(p, 4)
    for k in (1, 3, 5):
        np.testing.assert_array_equal(fid._knn_radii(a, k, batch=7),
                                      jax_fid._knn_radii(a, k, batch=7))
        assert fid.compute_precision_recall(a, b, k, batch=9) == \
            jax_fid.compute_precision_recall(a, b, k, batch=9)
    # a singular covariance takes the offset branch in both
    mu, sigma = np.zeros(3), np.diag([1.0, 0.0, 0.0])
    assert fid.frechet_distance(mu, sigma, mu + 1, sigma) == \
        jax_fid.frechet_distance(mu, sigma, mu + 1, sigma)


def test_sqrtm_without_disp_equals_jax(monkeypatch):
    """scipy 1.18 dropped ``sqrtm``'s ``disp`` argument, which JAX's copy
    passes; the port calls ``sqrtm(a)`` there.  Forced onto that
    call here, the distances equal JAX's (``sqrtm(a, disp=False)[0]``)."""
    monkeypatch.setattr(fid, "_SQRTM_DISP", False)
    a, b = _features(10)["pool3"], _features(11, shift=0.4)["pool3"]
    assert fid.compute_fid(a, b) == jax_fid.compute_fid(a, b)
    sp_a, sp_b = _features(10)["spatial"], _features(11)["spatial"]
    assert fid.compute_fid(sp_a, sp_b) == jax_fid.compute_fid(sp_a, sp_b)


def test_clip_score_from_features_equals_jax():
    rng = np.random.RandomState(5)
    ie, te = rng.randn(12, 16), rng.randn(12, 16)
    te[:6] = ie[:6] + 0.1 * te[:6]
    got = clip_score.clip_score_from_features(ie, te)
    assert got == jax_clip_score.clip_score_from_features(ie, te)
    assert 0 <= got <= 100


def test_npz_io_equals_jax(tmp_path):
    lat = np.random.RandomState(6).randn(3, 3, 8, 8).astype(np.float32)
    np.testing.assert_array_equal(npz_io.latents_to_images(lat),
                                  jax_npz.latents_to_images(lat))
    from PIL import Image
    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.RandomState(7)
    for i, size in enumerate((16, 20, 16)):
        Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(
            folder / f"{i}.png")
    got = npz_io.images_to_npz(str(folder), str(tmp_path / "a.npz"), 16)
    want = jax_npz.images_to_npz(str(folder), str(tmp_path / "b.npz"), 16)
    np.testing.assert_array_equal(npz_io.load_npz_images(got),
                                  jax_npz.load_npz_images(want))
    ann = {"annotations": [{"image_id": 2, "caption": "b cat\n"},
                           {"image_id": 1, "caption": " a dog "},
                           {"image_id": 2, "caption": "another"}]}
    with open(tmp_path / "ann.json", "w") as f:
        json.dump(ann, f)
    npz_io.extract_coco_captions(str(tmp_path / "ann.json"),
                                 str(tmp_path / "p.txt"))
    jax_npz.extract_coco_captions(str(tmp_path / "ann.json"),
                                  str(tmp_path / "q.txt"))
    assert (tmp_path / "p.txt").read_text() == \
        (tmp_path / "q.txt").read_text() == "a dog\nb cat\n"


def test_run_eval_features_cli_equals_jax(tmp_path, capsys):
    """Feature npzs in (``--features``-style: pool3/spatial/pred keys), one
    JSON line out, the same as JAX's; ``--save-features`` writes the
    generated side."""
    ref, gen = tmp_path / "ref.npz", tmp_path / "gen.npz"
    np.savez(ref, **_features(8, 40))
    np.savez(gen, **_features(9, 40, 0.2))
    got = run_eval.main(["--ref", str(ref), "--gen", str(gen),
                         "--device", "cpu", "--save-features",
                         str(tmp_path / "saved.npz")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = jax_run_eval.main(["--ref", str(ref), "--gen", str(gen)])
    assert got == want and json.loads(line) == want
    saved = np.load(tmp_path / "saved.npz")
    np.testing.assert_array_equal(saved["pool3"], np.load(gen)["pool3"])
    # an image npz without --inception is refused, as in JAX
    np.savez(tmp_path / "imgs.npz", arr_0=np.zeros((2, 8, 8, 3), np.uint8))
    with pytest.raises(SystemExit, match="inception"):
        run_eval.main(["--ref", str(ref), "--gen",
                       str(tmp_path / "imgs.npz"), "--device", "cpu"])
