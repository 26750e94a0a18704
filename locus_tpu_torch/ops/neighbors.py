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

from locus_tpu_torch.core.cloud import take_rows
from locus_tpu_torch.utils.linalg import sum_last

# elements of one distance block: a (B, rows, chunk + k) f32 block stays
# near 64 MB
_BLOCK_ELEMS = 1 << 24


def fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 dot product of the 3-vectors a (..., 3) and b (..., 3) as a
    chain of fused multiply-adds, x0*y0, then + x1*y1, then + x2*y2, each
    step rounded once to f32 (emulated in float64, where an f32 product is
    exact). XLA's dot and torch's GEMM on the CPU round this way (bit for
    bit on the test scans); elementwise ops, unlike a GEMM, round alike
    for a batch member and its single call, on the CPU and on the card."""
    a, b = a.double(), b.double()
    acc = (a[..., 0] * b[..., 0]).float().double()
    acc = (a[..., 1] * b[..., 1] + acc).float().double()
    return (a[..., 2] * b[..., 2] + acc).float()


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(...,N,3),(...,M,3) -> (...,N,M) squared distances, |a|^2 + |b|^2 -
    2 a.b, clamped at 0. The dot product is `fma_dot3`, not a GEMM: a
    batched GEMM may round differently from a single one, and each batch
    member must round as its single call does (the k-NN order at near
    ties follows the rounding)."""
    a2 = sum_last(a * a)
    b2 = sum_last(b * b)
    dot = fma_dot3(a[..., :, None, :], b[..., None, :, :])
    d2 = a2[..., :, None] + b2[..., None, :] - 2.0 * dot
    return torch.clamp(d2, min=0.0)


def nearest(query: torch.Tensor, target: torch.Tensor, chunk: int = 4096):
    """Exact 1-NN: (...,N) squared distance and (...,N) int64 index; ties go
    to the lowest index. Targets are scanned in chunks of `chunk` columns so
    the (N, M) matrix never materialises whole."""
    lead_n = query.shape[:-1]
    best_d = torch.full(lead_n, float("inf"), device=query.device)
    best_i = torch.zeros(lead_n, dtype=torch.int64, device=query.device)
    for start in range(0, target.shape[-2], chunk):
        d2 = pairwise_sqdist(query, target[..., start : start + chunk, :])
        d, i = torch.min(d2, dim=-1)
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_i = torch.where(take, i + start, best_i)
    return best_d, best_i


def _smallest_k(d2: torch.Tensor, idx: torch.Tensor, k: int):
    """The k smallest of each row, ascending; equal distances keep their
    column order (a stable sort), as `lax.top_k` keeps the lower index."""
    d_s, order = torch.sort(d2, dim=-1, stable=True)
    return d_s[..., :k], torch.gather(idx, -1, order[..., :k])


def knn(query: torch.Tensor, target: torch.Tensor, k: int, chunk: int = 4096):
    """Exact k-NN of each query point in `target`: ((...,N,k) squared
    distances ascending, (...,N,k) int64 indices). Padded targets
    (PAD_COORD) lie far away and come last. Targets beyond `chunk` are
    scanned chunk by chunk with a running merge, the running best before
    the new chunk, so ties go to the lower index as in the JAX function.
    With a leading batch dimension each member searches its own target;
    the row blocks span all members, and every row is searched alone, so a
    member's result does not depend on the batch."""
    n, m = query.shape[-2], target.shape[-2]
    lead = query.shape[:-2]
    k = min(k, m)
    dev = query.device
    out_d = torch.empty(lead + (n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty(lead + (n, k), dtype=torch.int64, device=dev)
    rows = max(1, _BLOCK_ELEMS // (lead.numel() * (min(m, chunk) + k)))
    for r0 in range(0, n, rows):
        qb = query[..., r0 : r0 + rows, :]
        best_d = best_i = None
        for start in range(0, m, chunk):
            d2 = pairwise_sqdist(qb, target[..., start : start + chunk, :])
            col = torch.arange(start, start + d2.shape[-1], device=dev).expand(d2.shape)
            if best_d is not None:
                d2 = torch.cat([best_d, d2], dim=-1)
                col = torch.cat([best_i, col], dim=-1)
            best_d, best_i = _smallest_k(d2, col, k)
        out_d[..., r0 : r0 + rows, :] = best_d
        out_i[..., r0 : r0 + rows, :] = best_i
    return out_d, out_i


def radius_count(query: torch.Tensor, target: torch.Tensor, radius: float, chunk: int = 4096) -> torch.Tensor:
    """(...,N) int32 number of targets within `radius` of each query (the
    query itself included when it is among the targets)."""
    r2 = radius * radius
    counts = torch.zeros(query.shape[:-1], dtype=torch.int32, device=query.device)
    for start in range(0, target.shape[-2], chunk):
        d2 = pairwise_sqdist(query, target[..., start : start + chunk, :])
        counts += torch.sum(d2 <= r2, dim=-1, dtype=torch.int32)
    return counts


def gather_knn(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(...,M,C) points at (...,N,k) neighbour indices -> (...,N,k,C)."""
    return take_rows(points, idx.flatten(-2)).unflatten(-2, idx.shape[-2:])
