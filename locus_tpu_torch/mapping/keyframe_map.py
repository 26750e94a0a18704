"""Keyframe sliding-window map (counterpart of
`locus_tpu/mapping/keyframe_map.py`, the ring structure).

A fixed-capacity point store in the world frame, written as a ring.
Inserts keep only points farther than `map_voxel_leaf` from every stored
point; the map-sliding-window refresh evicts points outside a box around
the robot. Map 1-NN runs on kernel B2 at BT against a cached operand
(`nn_aug`, one [-2x, -2y, -2z, |t|^2] row per slot) and cached chunk
boxes, both maintained incrementally.

Inserts and refreshes run every scan as masked passes (`enabled`): a
disabled call leaves the state bit-identical. A loop closure moves the
stored points by their keyframe's correction (`reanchor`), which rebuilds
the operand and the chunk boxes from the moved points.

The point axis can be split over the "map" axis of a process mesh (the
sharded deployments of `runner` and `live`): inside
`dispatch.shard_context` every map leaf this module sees is this rank's
shard, and the cross-shard results come from rank-ordered gathers: the
map 1-NN and the ANN merge the shards' winners (`sharded_map.merge_winners`,
least score, ties to the lowest shard: the whole map's winner), an insert
writes the slots its shard owns, and `map_size` sums the shards' counts.
`refresh_msw` and `reanchor` need nothing from other shards.

Every function also takes a state with one leading batch dimension (the
batched replay): each member has its own store, ring pointer and restart,
operand cache, chunk boxes and `enabled` flag; the map 1-NN then runs
kernel B3 once for all members.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from locus_tpu_torch.config import MapperConfig
from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud, put_rows, take_rows
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.ops.dispatch import active_shard, resolve_device
from locus_tpu_torch.ops.kernels.nn import (
    BT,
    build_nn_target,
    chunk_boxes,
    nearest_bounded_pre,
    nearest_bounded_scores,
    sq_norm3,
    update_chunk_boxes,
    update_nn_target,
)
from locus_tpu_torch.parallel import sharded_map
from locus_tpu_torch.parallel.distributed import gather_ranked


class MapState(NamedTuple):
    cloud: PointCloud               # world-frame stored points (+normals)
    write_ptr: torch.Tensor         # int32 ring pointer
    num_keyframes: torch.Tensor     # int32
    last_refresh_position: torch.Tensor  # (3,) of the last MSW refresh
    nn_aug: torch.Tensor            # (m_pad, 4) cached 1-NN operand
    chunk_min: torch.Tensor         # (C,3) cached per-chunk bbox minima
    chunk_max: torch.Tensor         # (C,3) maxima: grown on insert, rebuilt on MSW
    kf_index: torch.Tensor          # (M,) int32 keyframe provenance (-1 = none)


def init_map(cfg: MapperConfig, device=None) -> MapState:
    """An empty map on `device` (None: the CUDA device)."""
    device = resolve_device(device)
    cloud = PointCloud.empty(cfg.map_capacity, device=device)
    nn_aug = build_nn_target(cloud.xyz)
    c_min, c_max = chunk_boxes(cloud.xyz, cloud.mask, nn_aug.shape[0])
    return MapState(
        cloud=cloud,
        write_ptr=torch.tensor(0, dtype=torch.int32, device=device),
        num_keyframes=torch.tensor(0, dtype=torch.int32, device=device),
        last_refresh_position=torch.zeros((3,), dtype=torch.float32, device=device),
        nn_aug=nn_aug,
        chunk_min=c_min,
        chunk_max=c_max,
        kf_index=torch.full((cfg.map_capacity,), -1, dtype=torch.int32, device=device),
    )


def _map_nearest(state: MapState, query_xyz: torch.Tensor, radius: float = 2.0):
    """Bounded 1-NN into the map store; hits beyond `radius` come back as
    d2 = +inf. Sharded, the shards' winners merge and the index is a row
    of the whole map."""
    mesh = active_shard()
    if mesh is None:
        return nearest_bounded_pre(
            query_xyz, state.nn_aug, state.cloud.xyz, state.chunk_min, state.chunk_max, radius, bt=BT
        )
    return sharded_map.sharded_nearest_pallas(
        mesh, query_xyz, state.cloud.xyz, state.nn_aug, state.chunk_min, state.chunk_max, radius
    )


def insert_keyframe(
    state: MapState,
    keyframe: PointCloud,
    cfg: MapperConfig,
    nearest_d2: torch.Tensor | None = None,
    enabled: torch.Tensor | None = None,
) -> MapState:
    """Insert a world-frame keyframe (mapper_->InsertPoints,
    Locus.cc:523-529): keep the points farther than `map_voxel_leaf` from
    every stored point and write them at the ring pointer.

    `nearest_d2` may carry the per-point map distances of this scan's ANN
    pass. `enabled` (bool tensor) makes the call a masked no-op when
    False. The write window [ptr, ptr + k) never wraps: when fewer than k
    slots remain, the pointer restarts at 0."""
    leaf2 = cfg.map_voxel_leaf * cfg.map_voxel_leaf
    if nearest_d2 is None:
        nearest_d2, _ = _map_nearest(state, keyframe.xyz, cfg.ann_search_radius)
    novel = keyframe.mask & (nearest_d2 > leaf2)
    if enabled is not None:
        novel = novel & enabled[..., None]

    kf = keyframe.with_mask(novel).compact()       # novel points to the front
    k = kf.capacity
    mesh = active_shard()
    local_cap = state.cloud.capacity
    cap = local_cap * (1 if mesh is None else mesh.shape["map"])   # the whole ring
    if k > cap:
        raise ValueError(f"keyframe capacity {k} exceeds the map capacity {cap}")
    dev = kf.xyz.device
    n_novel = kf.count()
    winmask = torch.arange(k, device=dev) < n_novel[..., None]
    ptr = torch.where(state.write_ptr > cap - k, 0, state.write_ptr)
    new_ptr = ptr + n_novel
    kf_inc = torch.ones_like(state.num_keyframes)
    if enabled is not None:
        # the pointer (and its restart) only moves on an enabled insert
        new_ptr = torch.where(enabled, new_ptr, state.write_ptr)
        kf_inc = enabled.to(torch.int32)
    slot = ptr.to(torch.int64)[..., None] + torch.arange(k, device=dev)   # (..., k)
    if mesh is not None:
        return _insert_owned(state, kf, winmask, slot, new_ptr, kf_inc, mesh.map_index * local_cap)

    def merge0(arr, newvals):
        """Read-modify-write of each member's [ptr, ptr + k) window of
        `arr`; only lanes where winmask holds take newvals."""
        w = winmask if arr.dim() == slot.dim() else winmask[..., None]
        new = torch.where(w, newvals, take_rows(arr, slot))
        index = slot if arr.dim() == slot.dim() else slot[..., None].expand(new.shape)
        return arr.scatter(slot.dim() - 1, index, new)

    cloud = state.cloud
    new_cloud = PointCloud(
        merge0(cloud.xyz, kf.xyz),
        merge0(cloud.normals, kf.normals),
        merge0(cloud.intensity, kf.intensity),
        merge0(cloud.mask, winmask),
    )
    kf_index = merge0(state.kf_index, state.num_keyframes[..., None].expand(slot.shape))
    # ptr + k <= cap <= m_pad: the padding rows are never touched
    kf_rows = torch.cat([-2.0 * kf.xyz, sq_norm3(kf.xyz)[..., None]], dim=-1)
    nn_aug = merge0(state.nn_aug, kf_rows)
    c_min, c_max = update_chunk_boxes(
        state.chunk_min, state.chunk_max, torch.where(kf.mask, slot, cap), kf.xyz, kf.mask
    )
    return MapState(
        cloud=new_cloud,
        write_ptr=new_ptr.to(torch.int32),
        num_keyframes=state.num_keyframes + kf_inc,
        last_refresh_position=state.last_refresh_position,
        nn_aug=nn_aug,
        chunk_min=c_min,
        chunk_max=c_max,
        kf_index=kf_index,
    )


def _insert_owned(state: MapState, kf: PointCloud, winmask, slot, new_ptr, kf_inc, offset: int) -> MapState:
    """The sharded insert: the ring's window [ptr, ptr + k) lies across the
    shards, so each shard scatters the window's slots it owns (whole-ring
    slot s is row s - offset here) and leaves the others to their owners.
    The single path's windowed read-modify-write writes the same rows with
    the same values."""
    local_cap = state.cloud.capacity
    mine = winmask & (slot >= offset) & (slot < offset + local_cap)
    rows = torch.where(mine, slot - offset, local_cap)           # local_cap: dropped
    cloud = state.cloud
    new_cloud = PointCloud(
        put_rows(cloud.xyz, rows, kf.xyz),
        put_rows(cloud.normals, rows, kf.normals),
        put_rows(cloud.intensity, rows, kf.intensity),
        put_rows(cloud.mask, rows, torch.ones((), dtype=torch.bool, device=rows.device)),
    )
    c_min, c_max = update_chunk_boxes(state.chunk_min, state.chunk_max, rows, kf.xyz, mine)
    return MapState(
        cloud=new_cloud,
        write_ptr=new_ptr.to(torch.int32),
        num_keyframes=state.num_keyframes + kf_inc,
        last_refresh_position=state.last_refresh_position,
        nn_aug=update_nn_target(state.nn_aug, rows, kf.xyz, mine),
        chunk_min=c_min,
        chunk_max=c_max,
        kf_index=put_rows(state.kf_index, rows, state.num_keyframes[..., None]),
    )


def refresh_msw(
    state: MapState, position: torch.Tensor, cfg: MapperConfig, enabled: torch.Tensor | None = None
) -> MapState:
    """Map-sliding-window refresh (mapper_->Refresh, Locus.cc:536-538):
    evict stored points outside a box_filter_size box centred on the
    robot. Evicted rows of the cached operand get |t|^2 = +inf (they can
    never win), and the chunk boxes are rebuilt exactly from the kept
    points."""
    if enabled is None:
        enabled = torch.ones(position.shape[:-1], dtype=torch.bool, device=position.device)
    half = cfg.box_filter_size * 0.5
    inside = torch.all(torch.abs(state.cloud.xyz - position[..., None, :]) <= half, dim=-1)
    keep = state.cloud.mask & (inside | ~enabled[..., None])
    evicted = state.cloud.mask & ~keep
    cloud = state.cloud.with_mask(keep)
    m_pad = state.nn_aug.shape[-2]
    ev_pad = torch.zeros(evicted.shape[:-1] + (m_pad,), dtype=torch.bool, device=evicted.device)
    ev_pad[..., : evicted.shape[-1]] = evicted
    nn_aug = state.nn_aug.clone()
    nn_aug[..., 3] = torch.where(ev_pad, float("inf"), state.nn_aug[..., 3])
    c_min, c_max = chunk_boxes(cloud.xyz, cloud.mask, m_pad)
    return state._replace(
        cloud=cloud,
        last_refresh_position=torch.where(enabled[..., None], position, state.last_refresh_position),
        nn_aug=nn_aug,
        chunk_min=c_min,
        chunk_max=c_max,
    )


def moved_by_keyframe(state, corrections: torch.Tensor):
    """The stored cloud with each point moved by its keyframe's correction
    (`corrections` (K,4,4), row k = T_new_k @ inv(T_old_k)), and the mask
    of the points it moved: those of keyframes 0..K-1. Slots without
    provenance (kf_index -1, e.g. a ground-truth map) stay in place."""
    K = corrections.shape[0]
    kf = state.kf_index.to(torch.int64)
    C = corrections.to(state.cloud.xyz)[torch.clamp(kf, 0, K - 1)]      # (M,4,4)
    move = (kf >= 0) & (kf < K) & state.cloud.mask
    R = se3.rotation(C)
    xyz = se3.matvec(R, state.cloud.xyz) + se3.translation(C)
    nrm = se3.matvec(R, state.cloud.normals)
    cloud = PointCloud(
        torch.where(move[:, None], xyz, state.cloud.xyz),
        torch.where(move[:, None], nrm, state.cloud.normals),
        state.cloud.intensity,
        state.cloud.mask,
    )
    return cloud, move


def reanchor(state: MapState, corrections: torch.Tensor, cfg: MapperConfig) -> MapState:
    """Re-anchor the stored map after a pose-graph (loop-closure)
    correction: the world points p = T_old @ p_sensor of keyframe k move to
    corrections[k] @ p. The reference leaves the map to its backend
    (PointCloudLocalization.h:114-117 only resets the pose); this map is
    owned here, so the scan-to-submap target must follow the corrected
    trajectory. The cached operand and chunk boxes are rebuilt from the
    moved points: boxes left stale would prune true neighbours silently."""
    if state.cloud.mask.dim() != 1:
        raise NotImplementedError(
            "reanchor of a batched map: no batched entry point re-anchors (MultiRobotSession has no "
            "loop-closure push-back); re-anchor one robot's map (pipeline.member) instead"
        )
    cloud, _ = moved_by_keyframe(state, corrections)
    nn_aug = build_nn_target(cloud.xyz, m_pad=state.nn_aug.shape[0])
    c_min, c_max = chunk_boxes(cloud.xyz, cloud.mask, nn_aug.shape[0])
    return state._replace(cloud=cloud, nn_aug=nn_aug, chunk_min=c_min, chunk_max=c_max)


def approx_nearest_neighbors(
    state: MapState, query: PointCloud, return_d2: bool = False, radius: float = 2.0
):
    """mapper_->ApproxNearestNeighbors (Locus.cc:479): the nearest stored
    point of each query point (world frame), as a cloud shaped like the
    query; queries with no map point within `radius` are masked. With
    return_d2, also the squared distances (reused by the insert's
    novelty gate).

    Sharded, the winner may lie on another shard: each shard takes its
    own winner's point (xyz, normal, intensity, validity) and the merge
    picks the whole map's winner's, one gather of N x 10 f32 a call."""
    mesh = active_shard()
    if mesh is None:
        d2, idx = _map_nearest(state, query.xyz, radius)
        stored = PointCloud(*(take_rows(a, idx) for a in state.cloud))
    else:
        score, d2, idx = nearest_bounded_scores(
            query.xyz, state.nn_aug, state.cloud.xyz, state.chunk_min, state.chunk_max, radius, bt=BT
        )
        local = PointCloud(*(take_rows(a, idx) for a in state.cloud))
        cols = torch.cat([d2[..., None], local.xyz, local.normals, local.intensity[..., None],
                          local.mask[..., None].to(torch.float32)], dim=-1)
        merged = sharded_map.merge_winners(mesh, score, cols)
        d2 = merged[..., 0]
        stored = PointCloud(merged[..., 1:4], merged[..., 4:7], merged[..., 7], merged[..., 8] > 0.5)
    mask = query.mask & stored.mask & torch.isfinite(d2)
    out = PointCloud(
        torch.where(mask[..., None], stored.xyz, PAD_COORD),
        torch.where(mask[..., None], stored.normals, 0.0),
        torch.where(mask, stored.intensity, 0.0),
        mask,
    )
    if return_d2:
        return out, torch.where(mask, d2, float("inf"))
    return out


def map_size(state: MapState) -> torch.Tensor:
    """Stored points; sharded, summed over the shards (exact integers)."""
    mesh = active_shard()
    if mesh is None:
        return state.cloud.count()
    return torch.stack(gather_ranked(state.cloud.count(), mesh)).sum(dim=0, dtype=state.cloud.count().dtype)


def snapshot_to_pcd(state, path: str) -> int:
    """Write the stored map to a PCD file (the reference's map snapshot via
    pointcloud_to_pcd); returns the number of points written."""
    from locus_tpu_torch.io import pcd

    mask = state.cloud.mask.cpu().numpy()
    xyz, normals, intensity = (a.cpu().numpy()[mask] for a in state.cloud[:3])
    pcd.write_pcd(path, xyz, normals=normals, intensity=intensity)
    return int(mask.sum())
