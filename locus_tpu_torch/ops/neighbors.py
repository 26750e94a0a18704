"""Dense nearest-neighbour primitives (counterpart of
`locus_tpu/ops/neighbors.py`): the plain reference that the 1-NN kernel
(`ops/kernels/nn.py`) is held against, and the k-NN search of the kNN
normals, the GICP covariance modes and the outlier filters.

The JAX package runs these as XLA, not as Pallas kernels, so they are
plain PyTorch here too. Distance matrices are built in blocks of query
rows and target columns, so the (N, M) matrix never materialises whole.
"""
from __future__ import annotations

import torch

# query rows of one block: a (rows, chunk + k) f32 block stays near 64 MB
_BLOCK_ELEMS = 1 << 24


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


def _smallest_k(d2: torch.Tensor, idx: torch.Tensor, k: int):
    """The k smallest of each row, ascending; equal distances keep their
    column order (a stable sort), as `lax.top_k` keeps the lower index."""
    d_s, order = torch.sort(d2, dim=1, stable=True)
    return d_s[:, :k], torch.gather(idx, 1, order[:, :k])


def knn(query: torch.Tensor, target: torch.Tensor, k: int, chunk: int = 4096):
    """Exact k-NN of each query point in `target`: ((N,k) squared
    distances ascending, (N,k) int64 indices). Padded targets (PAD_COORD)
    lie far away and come last. Targets beyond `chunk` are scanned chunk by
    chunk with a running merge, the running best before the new chunk, so
    ties go to the lower index as in the JAX function."""
    n, m = query.shape[0], target.shape[0]
    k = min(k, m)
    dev = query.device
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int64, device=dev)
    rows = max(1, _BLOCK_ELEMS // (min(m, chunk) + k))
    for r0 in range(0, n, rows):
        qb = query[r0 : r0 + rows]
        best_d = best_i = None
        for start in range(0, m, chunk):
            d2 = pairwise_sqdist(qb, target[start : start + chunk])
            col = torch.arange(start, start + d2.shape[1], device=dev).expand(d2.shape)
            if best_d is not None:
                d2 = torch.cat([best_d, d2], dim=1)
                col = torch.cat([best_i, col], dim=1)
            best_d, best_i = _smallest_k(d2, col, k)
        out_d[r0 : r0 + rows] = best_d
        out_i[r0 : r0 + rows] = best_i
    return out_d, out_i


def radius_count(query: torch.Tensor, target: torch.Tensor, radius: float, chunk: int = 4096) -> torch.Tensor:
    """(N,) int32 number of targets within `radius` of each query (the
    query itself included when it is among the targets)."""
    r2 = radius * radius
    counts = torch.zeros((query.shape[0],), dtype=torch.int32, device=query.device)
    for start in range(0, target.shape[0], chunk):
        d2 = pairwise_sqdist(query, target[start : start + chunk])
        counts += torch.sum(d2 <= r2, dim=1, dtype=torch.int32)
    return counts


def gather_knn(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M,3) points at (N,k) neighbour indices -> (N,k,3)."""
    return points[idx]
