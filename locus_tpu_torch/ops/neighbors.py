"""Dense nearest-neighbour primitives (counterpart of
`locus_tpu/ops/neighbors.py`): the plain reference that the 1-NN kernel
(`ops/kernels/nn.py`) is held against. This slice ports
`pairwise_sqdist` and `nearest`; `knn`, `radius_count` and `gather_knn`
come with ROADMAP item A11 (the outlier filters and kNN normals)."""
from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,3),(M,3) -> (N,M) squared distances, |a|^2 + |b|^2 - 2 a.b,
    clamped at 0."""
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    d2 = a2[:, None] + b2[None, :] - 2.0 * (a @ b.T)
    return torch.clamp(d2, min=0.0)


def nearest(query: torch.Tensor, target: torch.Tensor, chunk: int = 4096):
    """Exact 1-NN: (N,) squared distance and (N,) int64 index; ties go to
    the lowest index. Targets are scanned in chunks of `chunk` columns so
    the (N, M) matrix never materialises whole."""
    best_d = torch.full((query.shape[0],), float("inf"), device=query.device)
    best_i = torch.zeros((query.shape[0],), dtype=torch.int64, device=query.device)
    for start in range(0, target.shape[0], chunk):
        d2 = pairwise_sqdist(query, target[start : start + chunk])
        d, i = torch.min(d2, dim=1)
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_i = torch.where(take, i + start, best_i)
    return best_d, best_i
