"""ELSA sign-projection hashing predictor (port of the JAX package's
``predictors/elsa.py``).

The structured orthogonal projection (Kronecker products of small bases by
modified Gram-Schmidt) is built in NumPy from a seeded ``RandomState``, in
the JAX package's order of draws and operations, so the two packages hold
the same float32 matrix bit for bit.  Kernels K3 and K4 take it as their
``proj`` operand.  ``ElsaApproximation`` is the emulation path's
predictor: k-bit sign hashes of the MX-quantized Q and K, and the score
||k|| * cos(pi/k * hamming - theta_bias), with the key norms taken at the
query index as the reference does (square attention only).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..ops.elemwise import quantize_elemwise_op
from ..ops.mx import quantize_mx_op

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


class ElsaApproximation:
    def __init__(self, Q: torch.Tensor, K: torch.Tensor, mx_specs,
                 orthogonal_matrix: Optional[torch.Tensor] = None):
        self.specs = mx_specs
        self.d = Q.shape[-1]
        self.k = K.shape[-1]

        def mxq(x):
            return quantize_mx_op(
                quantize_elemwise_op(x, mx_specs, round=mx_specs.round_output),
                mx_specs, elem_format=mx_specs.a_elem_format, axes=[-1],
                round=mx_specs.round_mx_output)

        self.MX_Q = mxq(Q)
        self.MX_K = mxq(K)
        if orthogonal_matrix is None:
            orthogonal_matrix = create_structured_orthogonal_matrix(self.d)
        self.projection_matrix = torch.as_tensor(
            orthogonal_matrix, dtype=torch.float32, device=Q.device)

    def compute_hashes(self, x: torch.Tensor) -> torch.Tensor:
        projected = torch.matmul(x.to(torch.float32),
                                 self.projection_matrix.t())
        return projected >= 0

    def approximation_scores(self) -> torch.Tensor:
        """(..., Nq, Nk) approximate similarities."""
        if self.MX_Q.shape[-2] != self.MX_K.shape[-2]:
            raise ValueError(
                "ELSA is square-self-attention-only: the reference applies "
                "the key norms at the QUERY index "
                "(elsa_approximation.py:139-141) and its cross-attention "
                "forward has no ELSA branch; use an exponent-family "
                f"pred_mode for cross attention (got Nq="
                f"{self.MX_Q.shape[-2]}, Nk={self.MX_K.shape[-2]})")
        qh = self.compute_hashes(self.MX_Q)
        kh = self.compute_hashes(self.MX_K)
        mk = self.MX_K.to(torch.float32)
        key_norms = torch.sqrt((mk * mk).sum(-1))
        s_q = qh.to(torch.float32) * 2.0 - 1.0
        s_k = kh.to(torch.float32) * 2.0 - 1.0
        dots = torch.matmul(s_q, s_k.transpose(-1, -2))  # exact: +-1 sums
        hamming = 0.5 * (self.k - dots)
        est_angles = (math.pi / self.k) * hamming
        corrected = (est_angles - THETA_BIAS).clamp(min=0.0)
        # the key norms at the row's own (query) index: a positive per-row
        # constant, so the selection ranks by cos(angle) alone
        return key_norms[..., :, None] * torch.cos(corrected)


def elsa_scores(Q, K, mx_specs, orthogonal_matrix=None):
    return ElsaApproximation(Q, K, mx_specs,
                             orthogonal_matrix).approximation_scores()

