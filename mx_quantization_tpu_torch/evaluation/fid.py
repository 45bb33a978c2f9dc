"""FID / sFID / Inception Score / precision-recall metric math (the port's
own copy of the JAX package's ``evaluation/fid.py``, numpy and scipy; the
reference's ADM evaluator, workloads/DiT/evaluations/evaluator.py:69-362).

  * FID: Frechet distance between Gaussian fits of pool_3 features
  * sFID: the same distance over the spatial features
  * Inception Score from softmax predictions
  * improved precision/recall from k-NN radii of the feature manifolds

Every function takes feature arrays on the host and gives the JAX
package's numbers exactly (the same numpy and scipy calls in the same
order).
"""

from __future__ import annotations

import inspect
from typing import Dict, Tuple

import numpy as np
from scipy import linalg

# scipy 1.18 dropped sqrtm's ``disp`` argument, which JAX's copy passes as
# False (the root and an error estimate, no printed warning): call it either
# way
_SQRTM_DISP = "disp" in inspect.signature(linalg.sqrtm).parameters


def _sqrtm(a: np.ndarray) -> np.ndarray:
    return linalg.sqrtm(a, disp=False)[0] if _SQRTM_DISP else linalg.sqrtm(a)


def compute_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) Gaussian fit of (N, D) features."""
    return np.mean(feats, axis=0), np.cov(feats, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (evaluator.py:69-118)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) -
                 2 * np.trace(covmean))


def compute_fid(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    return frechet_distance(*compute_statistics(feats_a),
                            *compute_statistics(feats_b))


def compute_inception_score(preds: np.ndarray, splits: int = 10) -> float:
    """IS from (N, classes) softmax predictions (evaluator.py:181-205)."""
    scores = []
    n = preds.shape[0]
    for i in range(splits):
        part = preds[i * n // splits:(i + 1) * n // splits]
        kl = part * (np.log(part + 1e-10) -
                     np.log(np.mean(part, axis=0, keepdims=True) + 1e-10))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores))


def _knn_radii(feats: np.ndarray, k: int = 3,
               batch: int = 2048) -> np.ndarray:
    """Distance to the k-th nearest neighbour of each row (not itself)."""
    n = len(feats)
    sq = np.sum(feats ** 2, axis=1)
    radii = np.empty(n, np.float64)
    for i in range(0, n, batch):
        block = feats[i:i + batch]
        d2 = np.maximum(sq[i:i + batch, None] + sq[None, :] -
                        2 * block @ feats.T, 0)
        # the k + 1 smallest include the zero distance to itself
        idx = np.argpartition(d2, k, axis=1)[:, :k + 1]
        part = np.take_along_axis(d2, idx, axis=1)
        radii[i:i + batch] = np.sqrt(np.sort(part, axis=1)[:, k])
    return radii


def compute_precision_recall(ref_feats: np.ndarray, gen_feats: np.ndarray,
                             k: int = 3, batch: int = 2048
                             ) -> Tuple[float, float]:
    """Improved precision/recall (ManifoldEstimator, evaluator.py:207-362):
    precision is the share of generated samples inside the reference
    manifold (within some reference point's k-NN radius); recall swaps
    the roles."""
    ref_radii = _knn_radii(ref_feats, k, batch)
    gen_radii = _knn_radii(gen_feats, k, batch)

    def fraction_covered(points, manifold, radii):
        sq_m = np.sum(manifold ** 2, axis=1)
        covered = np.zeros(len(points), bool)
        for i in range(0, len(points), batch):
            block = points[i:i + batch]
            d2 = (np.sum(block ** 2, axis=1)[:, None] + sq_m[None, :] -
                  2 * block @ manifold.T)
            covered[i:i + batch] = np.any(
                np.sqrt(np.maximum(d2, 0)) <= radii[None, :], axis=1)
        return float(np.mean(covered))

    precision = fraction_covered(gen_feats, ref_feats, ref_radii)
    recall = fraction_covered(ref_feats, gen_feats, gen_radii)
    return precision, recall


def full_report(ref_pool: np.ndarray, gen_pool: np.ndarray,
                ref_spatial=None, gen_spatial=None,
                gen_preds=None) -> Dict[str, float]:
    """The evaluator's printed metric set (evaluator.py:56-62)."""
    out = {"fid": compute_fid(ref_pool, gen_pool)}
    if ref_spatial is not None and gen_spatial is not None:
        out["sfid"] = compute_fid(ref_spatial, gen_spatial)
    if gen_preds is not None:
        out["inception_score"] = compute_inception_score(gen_preds)
    out["precision"], out["recall"] = compute_precision_recall(ref_pool,
                                                               gen_pool)
    return out
