"""Voxel-grid downsampling and the adaptive input-voxelization law
(counterpart of `locus_tpu/ops/voxel.py`).

Points are keyed by integer voxel coordinates and sorted stably; runs of
equal keys become segments, and per-voxel centroids are per-segment sums.
The output comes in sorted-voxel-key order, the same order as the JAX
package gives: both kernels' box pruning relies on that spatial coherence,
and the same order gives the same point indices.
"""
from __future__ import annotations

import os

import torch

from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud, take_rows

# Voxel coordinates are offset into [0, 2^20) per axis.
_COORD_OFFSET = 1 << 19
_COORD_MAX = (1 << 20) - 1

# Packed-key variant for the downsample sort: 15 bits per axis around the
# origin (163 m at the 0.01 minimum leaf); clamped coordinates merge at the
# boundary.
_PACK_OFFSET = 1 << 14
_PACK_MAX = (1 << 15) - 1


def voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, leaf) -> torch.Tensor:
    """(N,3) points -> (N,3) int32 voxel coords; invalid lanes get the max
    key so they sort to the end."""
    ijk = torch.floor(xyz / leaf).to(torch.int32) + _COORD_OFFSET
    ijk = torch.clamp(ijk, 0, _COORD_MAX - 1)
    return torch.where(mask[:, None], ijk, _COORD_MAX)


def _segment_offsets(is_new: torch.Tensor) -> torch.Tensor:
    """Start offsets of the segments of sorted key runs (..., n), flat over
    the members: member b's n possible segments take offsets b*n .. b*n+n-1,
    segment k starting at its k-th run start and the unused ones starting
    (and ending) at the member's end (b+1)*n; one closing offset follows.
    A member's sums thus land in rows b*n .. b*n+n-1 of the flat result.
    Built without a host sync."""
    n = is_new.shape[-1]
    seg = torch.cumsum(is_new.to(torch.int64), -1) - 1
    # non-start lanes write to the extra slot n, then cut off
    idx = torch.where(is_new, seg, n)
    offsets = torch.full(is_new.shape[:-1] + (n + 1,), n, dtype=torch.int64, device=is_new.device)
    offsets.scatter_(-1, idx, torch.arange(n, device=is_new.device).expand(is_new.shape))
    base = torch.arange(0, is_new.numel(), n, device=is_new.device).reshape(is_new.shape[:-1] + (1,))
    end = torch.full((1,), is_new.numel(), dtype=torch.int64, device=is_new.device)
    return torch.cat([(offsets[..., :n] + base).reshape(-1), end])


def voxel_downsample(
    cloud: PointCloud,
    leaf,
    capacity: int | None = None,
    with_attributes: bool = True,
) -> PointCloud:
    """Voxel-grid downsample: one centroid per occupied voxel.

    xyz, normals and intensity are averaged per voxel and normals are
    re-normalised. `leaf` may be a 0-d tensor (the runtime-adaptive leaf).
    A cloud with a leading batch dimension takes a (B,) leaf, one per
    member: each member is sorted along its own points (the int64 keys
    along the last axis) and its segment sums are offset by member.
    `with_attributes=False` skips averaging normals and intensity and
    returns zeros for both; it is only the identity when those columns are
    zero, which `LOCUS_DEBUG_CHECKS` verifies eagerly.
    """
    n = cloud.capacity
    cap = capacity if capacity is not None else n
    dev = cloud.xyz.device
    lead = cloud.mask.shape[:-1]
    if not with_attributes and os.environ.get("LOCUS_DEBUG_CHECKS"):
        m = cloud.mask
        if bool(torch.any(cloud.normals[m] != 0)) or bool(torch.any(cloud.intensity[m] != 0)):
            raise ValueError(
                "voxel_downsample(with_attributes=False) called with non-zero "
                "normals/intensity; the attributes would be dropped"
            )
    leaf = torch.as_tensor(leaf, dtype=torch.float32, device=dev)[..., None]   # (..., 1)
    ij = torch.clamp(
        torch.floor(cloud.xyz[..., :2] / leaf[..., None]).to(torch.int64) + _PACK_OFFSET, 0, _PACK_MAX
    )
    kz = torch.clamp(
        torch.floor(cloud.xyz[..., 2] / leaf).to(torch.int64) + _PACK_OFFSET, 0, _PACK_MAX
    )
    key_xy = ij[..., 0] * (_PACK_MAX + 1) + ij[..., 1]
    key_xy = torch.where(cloud.mask, key_xy, (_PACK_MAX + 1) * (_PACK_MAX + 1))
    kz = torch.where(cloud.mask, kz, _PACK_MAX + 1)
    # one int64 key (key_xy, kz) in lexicographic order: kz < 2^16
    key = (key_xy << 16) | kz

    w0 = cloud.mask.to(torch.float32)[..., None]
    cols = [w0, cloud.xyz * w0]
    if with_attributes:
        cols += [cloud.normals * w0, cloud.intensity[..., None] * w0]
    payload = torch.cat(cols, dim=-1)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    payload_s = take_rows(payload, order)

    is_new = torch.ones(key.shape, dtype=torch.bool, device=dev)
    is_new[..., 1:] = key_s[..., 1:] != key_s[..., :-1]
    # Per-segment sums in order along each segment (no float atomics, so
    # the result does not depend on the schedule).
    acc = torch.segment_reduce(
        payload_s.reshape(-1, payload.shape[-1]), "sum",
        offsets=_segment_offsets(is_new), axis=0, unsafe=True,
    ).reshape(payload.shape)

    # More voxels than `cap`: stride-sample the valid range so the kept
    # voxels cover the whole scene (a prefix would keep the lowest keys).
    if cap != n:
        num_valid = torch.sum(acc[..., 0] > 0.0, dim=-1, dtype=torch.int32)[..., None]
        ar = torch.arange(cap, dtype=torch.int32, device=dev).expand(lead + (cap,))
        strided = (ar.to(torch.float32) * (num_valid.to(torch.float32) / cap)).to(torch.int32)
        take = torch.where(num_valid <= cap, ar, torch.clamp(strided, max=n - 1))
        acc = take_rows(acc, take.to(torch.int64))

    counts = acc[..., 0]
    denom = torch.clamp(counts, min=1.0)
    cx = acc[..., 1:4] / denom[..., None]
    valid = counts > 0.0
    if with_attributes:
        nsum = acc[..., 4:7]
        cn = nsum / torch.clamp(torch.linalg.norm(nsum, dim=-1, keepdim=True), min=1e-12)
        normals = torch.where(valid[..., None], cn, 0.0)
        intensity = torch.where(valid, acc[..., 7] / denom, 0.0)
    else:
        normals = torch.zeros_like(cx)
        intensity = torch.zeros_like(counts)
    return PointCloud(torch.where(valid[..., None], cx, PAD_COORD), normals, intensity, valid)


def adaptive_leaf_update(
    leaf: torch.Tensor,
    num_points: torch.Tensor,
    target_points: int,
    leaf_min: float = 0.01,
    leaf_max: float = 5.0,
):
    """Adaptive input-voxelization feedback law (Locus.cc:780-810):
    next_leaf = clip(leaf * n/target, leaf_min, leaf_max). Returns
    (next_leaf, changed), `changed` being the reference's |delta| > 0.01."""
    proposal = leaf * (num_points.to(torch.float32) / float(target_points))
    proposal = torch.clamp(proposal, leaf_min, leaf_max)
    changed = torch.abs(leaf - proposal) > 0.01
    return torch.where(changed, proposal, leaf), changed
