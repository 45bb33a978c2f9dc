"""ELSA's structured orthogonal projection (port of the host-side part of
the JAX package's ``predictors/elsa.py``: ``THETA_BIAS``,
``modified_gram_schmidt`` and ``create_structured_orthogonal_matrix``).

The matrix is built in NumPy from a seeded ``RandomState``, in the JAX
package's order of draws and operations, so the two packages hold the same
float32 matrix bit for bit.  Kernels K3 and K4 take it as their ``proj``
operand: the hash of a quantized q or k row is the sign of each projection
(``ops/kernels/topk_attention.py``).  The XLA-path predictor
(``ElsaApproximation``) waits for the emulation engine (ROADMAP.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

THETA_BIAS = 0.127  # the paper's angle bias, calibrated at d = 64, k = 64


def modified_gram_schmidt(dim: int, rng: np.random.RandomState) -> np.ndarray:
    """Random orthogonal basis by modified Gram-Schmidt over N(0, 1) draws."""
    v = rng.randn(dim, dim).astype(np.float64)
    basis = np.zeros_like(v)
    for i in range(dim):
        u = v[i]
        for j in range(i):
            u = u - np.dot(basis[j], u) * basis[j]
        n = np.linalg.norm(u)
        if n < 1e-10:
            raise RuntimeError("Vectors are not linearly independent.")
        basis[i] = u / n
    return basis.astype(np.float32)


def create_structured_orthogonal_matrix(dim: int, seed: int = 0) -> np.ndarray:
    """(dim, dim) orthogonal projection as Kronecker products of small
    bases: 4 x 4 x 4 at dim 64, 8 x 9 at dim 72."""
    rng = np.random.RandomState(seed)
    if dim == 64:
        a1 = modified_gram_schmidt(4, rng)
        a2 = modified_gram_schmidt(4, rng)
        a3 = modified_gram_schmidt(4, rng)
        return np.kron(np.kron(a1, a2), a3)
    if dim == 72:
        a1 = modified_gram_schmidt(8, rng)
        a2 = modified_gram_schmidt(9, rng)
        return np.kron(a1, a2)
    raise ValueError(
        f"No structured matrix construction defined for d={dim}; add a "
        "factorization in create_structured_orthogonal_matrix.")


@functools.lru_cache(maxsize=None)
def orthogonal_matrix(dim: int, device) -> torch.Tensor:
    """``create_structured_orthogonal_matrix(dim)`` as a float32 tensor on
    ``device``, built once per (dim, device)."""
    return torch.from_numpy(create_structured_orthogonal_matrix(dim)).to(
        device)
