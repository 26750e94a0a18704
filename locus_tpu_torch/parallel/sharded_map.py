"""Nearest neighbours against a map split over the mesh's "map" axis
(counterpart of `locus_tpu/parallel/sharded_map.py`).

Each rank holds one shard of the map's points and answers a query set
replicated on every rank; the winners of the shards then merge:

    shard-local search  ->  gather the shards' candidates in rank order
    ->  the same merge on every rank

which moves k values a query a shard, whatever the map's size. The
sharded deployments (`runner.make_scan_replay(mesh=)` and the rest) merge
inside `mapping.keyframe_map`: its map 1-NN is `sharded_nearest_pallas`,
its ANN merges each shard's winning point with `merge_winners`.
`sharded_knn` and `sharded_nearest` are the standalone API for k-NN
against a sharded point set.
"""
from __future__ import annotations

import torch

from locus_tpu_torch.ops import neighbors
from locus_tpu_torch.ops.kernels.nn import BT, nearest_bounded_scores
from locus_tpu_torch.parallel.distributed import gather_ranked


def _offset(mesh, local_m: int, axis: str) -> int:
    return mesh.index(axis) * local_m


def sharded_knn(mesh, query: torch.Tensor, map_xyz: torch.Tensor, k: int, axis: str = "map"):
    """Exact k-NN of a replicated query (N, 3) against this rank's shard
    `map_xyz` (M / shards, 3) of the map: (d2 (N, k), idx (N, k)) with idx
    in whole-map rows, the same on every rank. Ties go to the lower row."""
    d2, idx = neighbors.knn(query, map_xyz, k=k)
    gidx = idx + _offset(mesh, map_xyz.shape[-2], axis)
    all_d2 = torch.cat(gather_ranked(d2, mesh, axis), dim=-1)        # shards in rank order
    all_idx = torch.cat(gather_ranked(gidx, mesh, axis), dim=-1)
    # a stable sort keeps the lower shard (and within it the lower row) first
    order = torch.sort(all_d2, dim=-1, stable=True).indices[..., :k]
    return torch.gather(all_d2, -1, order), torch.gather(all_idx, -1, order)


def sharded_nearest(mesh, query: torch.Tensor, map_xyz: torch.Tensor, axis: str = "map"):
    """`sharded_knn` with k = 1: (d2 (N,), idx (N,))."""
    d2, idx = sharded_knn(mesh, query, map_xyz, k=1, axis=axis)
    return d2[..., 0], idx[..., 0]


def pallas_shardable(mesh, capacity: int, axis: str = "map") -> bool:
    """True when a map of `capacity` points splits over `axis` into shards
    of whole B2 target chunks (BT points each), so every shard's kernel
    sees the same chunks the whole map's would. (The name is the JAX
    package's, where the kernel was a Pallas kernel.)"""
    return capacity % (mesh.shape[axis] * BT) == 0


def merge_winners(mesh, score: torch.Tensor, cols: torch.Tensor, axis: str = "map") -> torch.Tensor:
    """Per query, the `cols` (..., N, C) of the shard whose winner has the
    least `score` (..., N); ties go to the lowest shard, whose winner is
    its lowest row, so the result is the whole map's winner. One gather of
    N x (C + 1) f32 a call."""
    packed = torch.cat([score[..., None], cols], dim=-1)
    all_ = torch.stack(gather_ranked(packed, mesh, axis))              # (S, ..., N, C + 1)
    best = torch.argmin(all_[..., 0], dim=0, keepdim=True)             # first minimum: lowest shard
    pick = best[..., None].expand((1,) + all_.shape[1:])
    return torch.take_along_dim(all_, pick, dim=0)[0, ..., 1:]


def index_bits(idx: torch.Tensor) -> torch.Tensor:
    """int rows as f32 bit patterns (exact, for `merge_winners`' columns)."""
    return idx.to(torch.int32).view(torch.float32)


def bits_index(col: torch.Tensor) -> torch.Tensor:
    """Inverse of `index_bits`."""
    return col.contiguous().view(torch.int32).to(torch.int64)


def sharded_nearest_pallas(
    mesh, query: torch.Tensor, map_xyz: torch.Tensor, nn_aug: torch.Tensor,
    c_min: torch.Tensor, c_max: torch.Tensor, radius: float = 2.0, axis: str = "map",
):
    """Radius-bounded exact 1-NN against a sharded map: kernel B2 on this
    rank's cached operand `nn_aug` (M / shards, 4) and chunk boxes, then
    one merge of the winners (`merge_winners`). Returns (d2 (N,), idx (N,))
    in whole-map rows; queries with no map point within `radius` get
    d2 = +inf. Takes a leading batch dimension (kernel B3). Requires
    `pallas_shardable`. The map's own 1-NN (`keyframe_map`) runs this."""
    if not pallas_shardable(mesh, map_xyz.shape[-2] * mesh.shape[axis], axis):
        raise ValueError(f"a shard of {map_xyz.shape[-2]} points is not whole {BT}-point chunks")
    score, d2, idx = nearest_bounded_scores(query, nn_aug, map_xyz, c_min, c_max, radius, bt=BT)
    gidx = idx + _offset(mesh, map_xyz.shape[-2], axis)
    merged = merge_winners(mesh, score, torch.stack([d2, index_bits(gidx)], dim=-1), axis)
    return merged[..., 0], bits_index(merged[..., 1])
