"""Voxel-hash slotted map store, the ikd-tree mapper analog (counterpart of
`locus_tpu/mapping/voxel_hash_map.py`; the reference's `mapperFabric`
choice, lo_settings.yaml:49-58).

Each stored point lives in the slot picked by a spatial hash of its
map-resolution voxel. An insert is one scatter: a point is written when
its slot is free or holds another voxel (a collision: the latest wins); a
slot holding the same voxel keeps its first point. The map sliding window
evicts by mask, as the ring store does. Queries go through the ring
store's ANN on kernel B2 at BT against the same cached operand and chunk
boxes (`keyframe_map.approx_nearest_neighbors`).

Because a slot is a hash of its voxel, every BT-slot chunk holds points
from across the whole window: the chunk boxes span the window and the map
ANN visits every chunk (B2's dense case).

Duplicate writes: every keyframe point of one new voxel hashes to the
same slot, so one insert writes many points to one slot. XLA's CPU
scatter applies them in order (the last wins); here the winner is picked
explicitly (`core.cloud.last_writes`), so the card's store equals the
CPU's and JAX's.

Sharded over the "map" axis of a process mesh (`dispatch.shard_context`),
each shard owns a contiguous range of the whole table's slots: the owner
answers the same-voxel test for its slots, a rank-ordered gather of the
answers gives every shard the same write mask, and each shard writes only
its own slots (`insert_keyframe`). Every function also takes a state with one leading batch
dimension (the batched replay): each member has its own slots, keys and
`enabled` flag, the duplicate writes are resolved within each member
(`last_writes` flattens the slots with a member offset), and the ANN runs
kernel B3 once for all members, visiting every chunk of every member.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from locus_tpu_torch.config import MapperConfig
from locus_tpu_torch.core.cloud import PointCloud, last_writes, put_rows, take_rows
from locus_tpu_torch.mapping import keyframe_map as _ring
from locus_tpu_torch.ops.dispatch import active_shard, resolve_device
from locus_tpu_torch.ops.kernels.nn import build_nn_target, chunk_boxes, update_chunk_boxes, update_nn_target
from locus_tpu_torch.parallel.distributed import gather_ranked

# Classic 3D spatial-hash primes (Teschner et al.)
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_INT32_MIN = -(1 << 31)


class HashMapState(NamedTuple):
    cloud: PointCloud               # world-frame stored points (+normals)
    keys: torch.Tensor              # (M,3) int32 voxel coordinates per slot
    occupied: torch.Tensor          # (M,) bool
    num_keyframes: torch.Tensor     # int32
    last_refresh_position: torch.Tensor  # (3,)
    nn_aug: torch.Tensor            # (m_pad, 4) cached 1-NN operand
    chunk_min: torch.Tensor         # (C,3) cached per-chunk bbox minima
    chunk_max: torch.Tensor         # (C,3) maxima (see keyframe_map)
    kf_index: torch.Tensor          # (M,) int32 keyframe provenance (-1 = none)


def init_map(cfg: MapperConfig, device=None) -> HashMapState:
    """An empty map on `device` (None: the CUDA device)."""
    device = resolve_device(device)
    cloud = PointCloud.empty(cfg.map_capacity, device=device)
    nn_aug = build_nn_target(cloud.xyz)
    c_min, c_max = chunk_boxes(cloud.xyz, cloud.mask, nn_aug.shape[0])
    return HashMapState(
        cloud=cloud,
        keys=torch.zeros((cfg.map_capacity, 3), dtype=torch.int32, device=device),
        occupied=torch.zeros((cfg.map_capacity,), dtype=torch.bool, device=device),
        num_keyframes=torch.tensor(0, dtype=torch.int32, device=device),
        last_refresh_position=torch.zeros((3,), dtype=torch.float32, device=device),
        nn_aug=nn_aug,
        chunk_min=c_min,
        chunk_max=c_max,
        kf_index=torch.full((cfg.map_capacity,), -1, dtype=torch.int32, device=device),
    )


def _voxel_ijk(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    return torch.floor(xyz / leaf).to(torch.int32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits (two's complement), kept
    in int64."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def _slot_of(ijk: torch.Tensor, capacity: int) -> torch.Tensor:
    """Slot of each voxel, bit for bit the JAX function's int32 arithmetic:
    `(i*P1) ^ (j*P2) ^ (k*P3)` wraps at 32 bits, `abs` of INT32_MIN stays
    INT32_MIN, and `%` is the floor modulo (non-negative for a positive
    capacity). Computed in int64 with the wraparound made explicit, so no
    signed overflow is left to the device."""
    c = ijk.to(torch.int64)
    h = _wrap32(c[..., 0] * _P1) ^ _wrap32(c[..., 1] * _P2) ^ _wrap32(c[..., 2] * _P3)
    a = torch.abs(h)
    a = torch.where(a == (1 << 31), _INT32_MIN, a)     # int32 abs(INT32_MIN) == INT32_MIN
    return torch.remainder(a, capacity)


def insert_keyframe(
    state: HashMapState,
    keyframe: PointCloud,
    cfg: MapperConfig,
    nearest_d2: torch.Tensor | None = None,
    enabled: torch.Tensor | None = None,
) -> HashMapState:
    """InsertPoints: scatter each keyframe point into its voxel's slot. A
    slot already holding the same voxel keeps its point (the octree's first
    return per cell); a free slot or another voxel's is overwritten.
    `nearest_d2` is accepted for the ring store's interface and ignored
    (dedup is intrinsic). `enabled` (bool tensor) makes the call a masked
    no-op when False."""
    del nearest_d2
    mesh = active_shard()
    cap = state.cloud.capacity
    ijk = _voxel_ijk(keyframe.xyz, cfg.map_voxel_leaf)
    if mesh is None:
        slot = _slot_of(ijk, cap)
        same_voxel = take_rows(state.occupied, slot) & torch.all(take_rows(state.keys, slot) == ijk, dim=-1)
        write = keyframe.mask & ~same_voxel
    else:
        # whole-table slot s lives on shard s // cap as row s % cap; the
        # owners' answers (the others say False) are OR-ed in rank order
        slot = _slot_of(ijk, cap * mesh.shape["map"]) - mesh.map_index * cap
        mine = (slot >= 0) & (slot < cap)
        row = torch.where(mine, slot, 0)
        same_here = mine & take_rows(state.occupied, row) & torch.all(take_rows(state.keys, row) == ijk, dim=-1)
        same_voxel = torch.stack(gather_ranked(same_here, mesh)).any(dim=0)
        write = keyframe.mask & ~same_voxel & mine
        slot = row
    if enabled is not None:
        write = write & enabled[..., None]
    idx = torch.where(write, slot, cap)          # cap: dropped
    # the last write to a slot wins (XLA's in-order CPU scatter); the
    # others are dropped, so every scatter below has unique rows
    win = last_writes(idx, cap)
    rows = torch.where(win, idx, cap)

    def put(arr, vals):
        return put_rows(arr, rows, vals)

    cloud = state.cloud
    new_cloud = PointCloud(
        put(cloud.xyz, keyframe.xyz),
        put(cloud.normals, keyframe.normals),
        put(cloud.intensity, keyframe.intensity),
        put(cloud.mask, torch.ones((), dtype=torch.bool, device=slot.device)),
    )
    # boxes grow by every write (a min/max does not care which one wins)
    c_min, c_max = update_chunk_boxes(state.chunk_min, state.chunk_max, idx, keyframe.xyz, write)
    kf_inc = torch.ones_like(state.num_keyframes) if enabled is None else enabled.to(torch.int32)
    return HashMapState(
        cloud=new_cloud,
        keys=put(state.keys, ijk),
        occupied=put(state.occupied, torch.ones((), dtype=torch.bool, device=slot.device)),
        num_keyframes=state.num_keyframes + kf_inc,
        last_refresh_position=state.last_refresh_position,
        nn_aug=update_nn_target(state.nn_aug, rows, keyframe.xyz, win),
        chunk_min=c_min,
        chunk_max=c_max,
        kf_index=put(state.kf_index, state.num_keyframes[..., None]),
    )


def refresh_msw(
    state: HashMapState, position: torch.Tensor, cfg: MapperConfig, enabled: torch.Tensor | None = None
) -> HashMapState:
    """Refresh: evict the slots outside the MSW box (freeing them). The
    evicted rows of the cached operand get |t|^2 = +inf, the chunk boxes
    are rebuilt exactly."""
    new = _ring.refresh_msw(state, position, cfg, enabled=enabled)
    return new._replace(occupied=new.cloud.mask)


def reanchor(state: HashMapState, corrections: torch.Tensor, cfg: MapperConfig) -> HashMapState:
    """Loop-closure re-anchoring (see `keyframe_map.reanchor`). The voxel
    keys of the moved points are recomputed so same-voxel dedup keeps
    working; slots keep their hash location, so a moved point may sit in a
    slot its new key would not hash to, and a later insert of that voxel
    lands in a second slot (one transient duplicate a voxel, cleared by the
    next MSW refresh), as in the JAX package."""
    cloud, move = _ring.moved_by_keyframe(state, corrections)
    keys = torch.where(move[:, None], _voxel_ijk(cloud.xyz, cfg.map_voxel_leaf), state.keys)
    nn_aug = build_nn_target(cloud.xyz, m_pad=state.nn_aug.shape[0])
    c_min, c_max = chunk_boxes(cloud.xyz, cloud.mask, nn_aug.shape[0])
    return state._replace(cloud=cloud, keys=keys, nn_aug=nn_aug, chunk_min=c_min, chunk_max=c_max)


def approx_nearest_neighbors(state: HashMapState, query: PointCloud, return_d2: bool = False, radius: float = 2.0):
    """The ring store's query (kernel B2 at BT on the cached operand)."""
    return _ring.approx_nearest_neighbors(state, query, return_d2=return_d2, radius=radius)


map_size = _ring.map_size


snapshot_to_pcd = _ring.snapshot_to_pcd
