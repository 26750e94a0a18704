"""Small fixed-size linear algebra for the hot path (counterpart of
`locus_tpu/utils/linalg.py`). Every function takes leading batch
dimensions (the batched replay)."""
from __future__ import annotations

from functools import lru_cache

import torch


def chol_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for small SPD H (...,n,n) by Cholesky factor and two
    triangular solves. The JAX version unrolls the factorisation into
    scalar ops and clamps each pivot at 1e-20; here one factorisation call
    replaces those ~150 scalar launches. For SPD H (every caller's H
    carries a Levenberg ridge) the two agree to f32 rounding.

    The solve runs in float64 and is rounded to f32 once: a batched solve
    may take another code path than a single one (and round differently),
    but float64 differences that small almost never survive the rounding,
    so a batch member gets the solution of its single solve."""
    L, _ = torch.linalg.cholesky_ex(H.double())
    return torch.cholesky_solve(g.double()[..., None], L)[..., 0].to(g.dtype)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (short) last axis, from left to right, in elementwise
    adds: unlike a reduction kernel, whose order may change with the batch,
    every member rounds as the single call does."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


def tree_sum(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Sum over `dim` by pairwise halving in elementwise adds, zero-padded
    to a power of two. The order of every addition is fixed by the shape
    of `dim` alone, so a batch member's sum rounds exactly like the same
    sum taken alone (a reduction kernel may split a batch differently)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        pad = list(x.shape)
        pad[dim] = size - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while size > 1:
        size //= 2
        x = x.narrow(dim, 0, size) + x.narrow(dim, size, size)
    return x.squeeze(dim)


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
    orthogonal matrix. Returns (eigvals ascending (...,N), eigvecs
    (...,N,N) columns), as `locus_tpu/utils/linalg.py::jacobi_eigh` does."""
    n = A.shape[-1]
    M = 0.5 * (A + A.transpose(-1, -2))
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    V = eye
    rounds = [
        (torch.tensor(pp, device=A.device), torch.tensor(qq, device=A.device))
        for pp, qq in _round_indices(n)
    ]
    for _ in range(sweeps):
        for pp, qq in rounds:
            apq = M[..., pp, qq]
            app = M[..., pp, pp]
            aqq = M[..., qq, qq]
            tau = (aqq - app) / (2.0 * torch.where(apq.abs() < 1e-30, 1e-30, apq))
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(
                apq.abs() < 1e-12 * (app.abs() + aqq.abs() + 1e-30), 0.0, t
            )
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            G = eye.clone()
            G[..., pp, pp] = c
            G[..., qq, qq] = c
            G[..., pp, qq] = s
            G[..., qq, pp] = -s
            M = G.transpose(-1, -2) @ M @ G
            V = V @ G
    eigvals = torch.diagonal(M, dim1=-2, dim2=-1)
    order = torch.argsort(eigvals, dim=-1, stable=True)
    return torch.take_along_dim(eigvals, order, dim=-1), torch.take_along_dim(V, order[..., None, :], dim=-1)
