"""Small fixed-size linear algebra for the hot path (counterpart of
`locus_tpu/utils/linalg.py`)."""
from __future__ import annotations

from functools import lru_cache

import torch


def chol_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for a small SPD H by Cholesky factor and two
    triangular solves. The JAX version unrolls the factorisation into
    scalar ops and clamps each pivot at 1e-20; here one factorisation call
    replaces those ~150 scalar launches. For SPD H (every caller's H
    carries a Levenberg ridge) the two agree to f32 rounding."""
    L, _ = torch.linalg.cholesky_ex(H)
    return torch.cholesky_solve(g[:, None], L)[:, 0]


def _round_robin_rounds(n: int):
    """Circle-method schedule: n-1 rounds of n/2 disjoint (p,q) pairs
    covering every pair exactly once (n even)."""
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        lineup = [0] + others
        pairs = []
        for k in range(n // 2):
            a, b = lineup[k], lineup[n - 1 - k]
            pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        others = others[-1:] + others[:-1]
    return rounds


@lru_cache(maxsize=None)
def _round_indices(n: int):
    rounds = _round_robin_rounds(n)
    return [([p for p, _ in pairs], [q for _, q in pairs]) for pairs in rounds]


def jacobi_eigh(A: torch.Tensor, sweeps: int = 6):
    """Symmetric NxN (N small, even) eigendecomposition by parallel-ordered
    Jacobi: each round applies n/2 disjoint rotations as one compound
    orthogonal matrix. Returns (eigvals ascending (N,), eigvecs (N,N)
    columns), as `locus_tpu/utils/linalg.py::jacobi_eigh` does."""
    n = A.shape[-1]
    M = 0.5 * (A + A.T)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye
    rounds = [
        (torch.tensor(pp, device=A.device), torch.tensor(qq, device=A.device))
        for pp, qq in _round_indices(n)
    ]
    for _ in range(sweeps):
        for pp, qq in rounds:
            apq = M[pp, qq]
            app = M[pp, pp]
            aqq = M[qq, qq]
            tau = (aqq - app) / (2.0 * torch.where(apq.abs() < 1e-30, 1e-30, apq))
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(
                apq.abs() < 1e-12 * (app.abs() + aqq.abs() + 1e-30), 0.0, t
            )
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            G = eye.clone()
            G[pp, pp] = c
            G[qq, qq] = c
            G[pp, qq] = s
            G[qq, pp] = -s
            M = G.T @ M @ G
            V = V @ G
    eigvals = torch.diagonal(M)
    order = torch.argsort(eigvals, stable=True)
    return eigvals[order], V[:, order]
