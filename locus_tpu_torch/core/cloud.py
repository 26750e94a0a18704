"""Fixed-capacity point-cloud container (counterpart of
`locus_tpu/core/cloud.py`).

A struct of tensors with a static padding budget and a validity mask.
Invalid lanes carry a far sentinel coordinate (PAD_COORD) so distance
tests push them out of range without extra branching. A cloud may carry
one leading batch dimension (one cloud per robot of the batched replay);
the methods work per member.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Far-away sentinel for padded points: 1e8^2 = 1e16 stays far inside f32
# range after squaring.
PAD_COORD = 1.0e8


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` (..., K) of x (..., M) or (..., M, C), per batch member:
    x[idx] on the single path."""
    if x.dim() == idx.dim():
        return torch.take_along_dim(x, idx, dim=-1)
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def _flat_rows(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Rows `idx` (..., K) of per-member `size`-row arrays as rows of the
    members' arrays laid end to end: member b's row r becomes b*size + r.
    Rows outside [0, size) go to the one row past the end, B*size."""
    lead = idx.shape[:-1]
    total = lead.numel() * size
    base = torch.arange(0, total, size, device=idx.device).reshape(lead + (1,))
    return torch.where((idx >= 0) & (idx < size), idx.to(torch.int64) + base, total)


def last_writes(idx: torch.Tensor, size: int) -> torch.Tensor:
    """(..., K) bool: which of K writes to rows `idx` of a `size`-row array
    are the last write to their row, per batch member. XLA's scatter on the
    CPU applies its updates in order, so the last write wins; CUDA's
    `index_put_` picks an arbitrary one. The winner here is the largest
    write position (an integer max, the same on every device). Writes
    outside [0, size) are dropped (False). Members never share a row: the
    rows are flattened with a member offset."""
    flat = _flat_rows(idx, size).reshape(-1)
    total = idx.shape[:-1].numel() * size
    pos = torch.arange(flat.shape[0], device=idx.device)
    last = torch.full((total + 1,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, flat, pos, "amax")
    return ((flat < total) & (torch.gather(last, 0, flat) == pos)).reshape(idx.shape)


def put_rows(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """`dst` (..., n, ...) with rows `rows` (..., K) set to `src` (..., K,
    ...) or a scalar, per batch member, where no row in [0, n) repeats
    within a member; rows equal to n are dropped."""
    lead = rows.shape[:-1]
    n = dst.shape[len(lead)]
    tail = dst.shape[len(lead) + 1:]
    flat_dst = dst.reshape((-1,) + tail)
    out = torch.cat([flat_dst, flat_dst.new_zeros((1,) + tail)])
    vals = src.to(dst.dtype).expand(rows.shape + tail).reshape((-1,) + tail)
    out.index_copy_(0, _flat_rows(rows, n).reshape(-1), vals)
    return out[:-1].reshape(dst.shape)   # the scratch row took the dropped writes


def scatter_rows(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """`dst` with rows `idx` (..., K) set to `src` (..., K, ...), per batch
    member: JAX's `dst.at[idx].set(src, mode="drop")` on the CPU (under
    vmap, batched). Rows outside the array are dropped; where several
    writes hit one row the last one wins (`last_writes`), so the result is
    the same on the CPU and the card."""
    n = dst.shape[idx.dim() - 1]
    return put_rows(dst, torch.where(last_writes(idx, n), idx.to(torch.int64), n), src)


class PointCloud(NamedTuple):
    """xyz (...,N,3) f32 (PAD_COORD on invalid lanes), normals (...,N,3) f32
    (zero on invalid lanes), intensity (...,N) f32, mask (...,N) bool."""

    xyz: torch.Tensor
    normals: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_points(
        cls,
        xyz,
        capacity: Optional[int] = None,
        normals=None,
        intensity=None,
        mask=None,
        device=None,
    ) -> "PointCloud":
        """Build a cloud from (M,3) points, padding/truncating to `capacity`."""
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
        dev = xyz.device
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        mask = (
            torch.ones((n,), dtype=torch.bool, device=dev)
            if mask is None
            else torch.as_tensor(mask, dtype=torch.bool, device=dev)
        )
        normals = (
            torch.zeros((n, 3), dtype=torch.float32, device=dev)
            if normals is None
            else torch.as_tensor(normals, dtype=torch.float32, device=dev)
        )
        intensity = (
            torch.zeros((n,), dtype=torch.float32, device=dev)
            if intensity is None
            else torch.as_tensor(intensity, dtype=torch.float32, device=dev)
        )

        def fit(a, fill):
            if a.shape[0] >= cap:
                return a[:cap]
            pad = torch.full((cap - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype, device=dev)
            return torch.cat([a, pad], dim=0)

        xyz = fit(xyz, PAD_COORD)
        normals = fit(normals, 0.0)
        intensity = fit(intensity, 0.0)
        mask = fit(mask, False)
        xyz = torch.where(mask[:, None], xyz, PAD_COORD)
        return cls(xyz, normals, intensity, mask)

    @classmethod
    def empty(cls, capacity: int, device=None) -> "PointCloud":
        return cls(
            torch.full((capacity, 3), PAD_COORD, dtype=torch.float32, device=device),
            torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            torch.zeros((capacity,), dtype=torch.float32, device=device),
            torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    # -- basic ops ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        """Number of valid points (int32 tensor (...) on the cloud's device)."""
        return torch.sum(self.mask, dim=-1, dtype=torch.int32)

    def with_mask(self, new_mask: torch.Tensor) -> "PointCloud":
        """Apply an additional mask; invalidated lanes get the sentinel."""
        m = self.mask & new_mask
        return PointCloud(
            torch.where(m[..., None], self.xyz, PAD_COORD),
            torch.where(m[..., None], self.normals, 0.0),
            torch.where(m, self.intensity, 0.0),
            m,
        )

    def transform(self, T: torch.Tensor) -> "PointCloud":
        """Rigidly transform points and rotate normals by a (...,4,4) transform."""
        from locus_tpu_torch.geometry import se3

        xyz = se3.transform_points(T, self.xyz)
        normals = se3.rotate_vectors(T, self.normals)
        xyz = torch.where(self.mask[..., None], xyz, PAD_COORD)
        normals = torch.where(self.mask[..., None], normals, 0.0)
        return PointCloud(xyz, normals, self.intensity, self.mask)

    def compact(self, capacity: Optional[int] = None) -> "PointCloud":
        """Stable partition of valid points to the front, as a gather by the
        inverse of the partition permutation (no sort)."""
        cap = capacity if capacity is not None else self.capacity
        n = self.capacity
        m = self.mask
        nv = torch.cumsum(m.to(torch.int64), -1)
        pos = torch.where(m, nv - 1, nv[..., -1:] + torch.cumsum((~m).to(torch.int64), -1) - 1)
        # pos is a permutation of 0..n-1 per member, so the scatter has no
        # duplicates
        take = torch.empty(m.shape, dtype=torch.int64, device=m.device)
        take.scatter_(-1, pos, torch.arange(n, device=m.device).expand(m.shape))
        take = take[..., :cap]
        return PointCloud(*(take_rows(a, take) for a in self))

    def centroid(self) -> torch.Tensor:
        """(...,3) mean of valid points."""
        w = self.mask.to(torch.float32)
        denom = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        safe_xyz = torch.where(self.mask[..., None], self.xyz, 0.0)
        return torch.sum(safe_xyz * w[..., None], dim=-2) / denom[..., None]


def concatenate(clouds, capacity: Optional[int] = None) -> PointCloud:
    """Concatenate clouds along the point axis (padding budget = sum), per
    batch member."""
    point_dim = clouds[0].mask.dim() - 1
    out = PointCloud(*(torch.cat(parts, dim=point_dim) for parts in zip(*clouds)))
    if capacity is not None and capacity != out.capacity:
        out = out.compact(capacity)
    return out
