"""LOAM-style feature extraction, edge and planar points (counterpart of
`locus_tpu/ops/features.py`; the reference's PointCloudFilter.cc:179-386).

Points are binned into a fixed (RINGS, W) range image by elevation ring
and azimuth, each ring is compacted into a point sequence, curvature is a
stencil along the ring, occluded and parallel-beam cells are excluded, and
per-region budgets pick SHARP/LESS_SHARP and FLAT labels greedily with
markAsPicked suppression; the remaining low-curvature cells are
LESS_FLAT. Fixed shapes, no data-dependent loops: plain PyTorch, as the
JAX package's is XLA.

Scatters: the range image keeps the nearest point of a cell (a min,
then the lowest point index among equal ranges), so each cell has one
writer, and every other scatter here writes each row at most once.
Binning rounds (`torch.round`, half to even as `jnp.round`); an azimuth
or elevation on a bin's edge may fall either side of it when `atan2`
differs by an ulp between XLA and torch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud

RINGS = 16
ELEV_MIN_DEG = -15.0
ELEV_STEP_DEG = 2.0

# labels
NONE = 0
SHARP = 1
LESS_SHARP = 2
FLAT = 3
LESS_FLAT = 4


class FeatureGrid(NamedTuple):
    xyz: torch.Tensor        # (RINGS, W, 3)
    valid: torch.Tensor      # (RINGS, W)
    curvature: torch.Tensor  # (RINGS, W)
    label: torch.Tensor      # (RINGS, W) int32
    src_idx: torch.Tensor    # (RINGS, W) int32 index of the cell's point in the source cloud (-1 empty)


def to_range_image(cloud: PointCloud, width: int = 1024, return_index: bool = False):
    """Bin the points into a (RINGS, width) grid by elevation ring and
    azimuth (arrangePCLInScanLines); a cell keeps its nearest point, and of
    equal ranges the lowest point index. With return_index, also each
    cell's source index (-1 empty)."""
    dev = cloud.xyz.device
    x, y, z = cloud.xyz[:, 0], cloud.xyz[:, 1], cloud.xyz[:, 2]
    rho = torch.sqrt(x * x + y * y)
    elev_deg = torch.rad2deg(torch.atan2(z, rho))
    ring = torch.round((elev_deg - ELEV_MIN_DEG) / ELEV_STEP_DEG).to(torch.int32)
    ring_ok = (ring >= 0) & (ring < RINGS)
    # round to the bin centre: a W-step sweep's rays land on the centres
    az = torch.atan2(y, x)
    col = torch.remainder(torch.round((az + math.pi) / (2 * math.pi) * width).to(torch.int32), width)
    ok = cloud.mask & ring_ok
    # one materialised range feeds both the min and the winner test
    rng = torch.sqrt(x * x + y * y + z * z)
    cells = RINGS * width
    flat_idx = torch.where(ok, ring * width + col, cells).to(torch.int64)

    range_grid = torch.full((cells + 1,), float("inf"), device=dev)
    range_grid.scatter_reduce_(0, flat_idx, torch.where(ok, rng, float("inf")), "amin")
    winner = ok & (rng <= range_grid[flat_idx])
    # equal ranges in one cell: the lowest lane wins
    n = cloud.capacity
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    tie_grid = torch.full((cells + 1,), n, dtype=torch.int32, device=dev)
    tie_grid.scatter_reduce_(0, torch.where(winner, flat_idx, cells), torch.where(winner, lane, n), "amin")
    winner = winner & (lane == tie_grid[flat_idx])

    dst = torch.where(winner, flat_idx, cells)     # one writer per cell
    grid = torch.full((cells + 1, 3), PAD_COORD, device=dev)
    grid[dst] = torch.where(winner[:, None], cloud.xyz, PAD_COORD)
    valid = torch.zeros((cells + 1,), dtype=torch.bool, device=dev)
    valid[dst] = winner
    out = (grid[:-1].reshape(RINGS, width, 3), valid[:-1].reshape(RINGS, width))
    if return_index:
        src = torch.full((cells + 1,), -1, dtype=torch.int32, device=dev)
        src[dst] = lane
        out = out + (src[:-1].reshape(RINGS, width),)
    # the scratch cell `cells` took every non-winner: cut off above
    return out


def _compact_rings(grid_xyz, valid, src_idx):
    """Stable per-ring compaction of the valid cells to the row prefix:
    the reference's scan lines are point sequences, and curvature, the
    picking gaps and the exclusions run over consecutive points."""
    rings, W = valid.shape
    dev = valid.device
    pos = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    tgt = torch.where(valid, pos, W)                      # W: the drop slot
    rows = torch.arange(rings, device=dev)[:, None].expand(rings, W)
    out_xyz = torch.full((rings, W + 1, 3), PAD_COORD, device=dev)
    out_xyz[rows, tgt] = grid_xyz
    out_valid = torch.zeros((rings, W + 1), dtype=torch.bool, device=dev)
    out_valid[rows, tgt] = valid
    out_src = torch.full((rings, W + 1), -1, dtype=torch.int32, device=dev)
    out_src[rows, tgt] = src_idx
    # the drop slot W took every invalid cell: cut off
    return out_xyz[:, :W], out_valid[:, :W], out_src[:, :W]


def compute_curvature(grid_xyz: torch.Tensor, valid: torch.Tensor, half: int = 5):
    """LOAM curvature c_i = || sum_{k != 0} (p_{i+k} - p_i) ||^2 over a
    2*half window along the ring; valid only where the whole window is."""
    total = torch.zeros_like(grid_xyz)
    all_valid = valid
    for k in range(-half, half + 1):
        if k == 0:
            continue
        total = total + (torch.roll(grid_xyz, -k, dims=1) - grid_xyz)
        all_valid = all_valid & torch.roll(valid, -k, dims=1)
    c = torch.sum(total * total, dim=-1)
    return torch.where(all_valid, c, float("inf")), all_valid


def unreliable_mask(grid_xyz: torch.Tensor, valid: torch.Tensor, half: int = 5) -> torch.Tensor:
    """Occluded-edge and parallel-beam exclusions (setScanBuffersFor,
    PointCloudFilter.cc:428-486): (1) a jump to the next cell with a small
    lateral offset suppresses `half`+1 cells on its far side; (2) a cell
    whose gaps to both neighbours exceed ~4x the expected tangential
    spacing is suppressed."""
    p = grid_xyz
    nxt = torch.roll(p, -1, dims=1)
    prv = torch.roll(p, 1, dims=1)
    v_nxt = torch.roll(valid, -1, dims=1)
    v_prv = torch.roll(valid, 1, dims=1)

    diff_next = torch.sum((nxt - p) ** 2, dim=-1)
    diff_prev = torch.sum((p - prv) ** 2, dim=-1)
    depth = torch.linalg.norm(p, dim=-1)
    depth_next = torch.linalg.norm(nxt, dim=-1)
    jump = valid & v_nxt & (diff_next > 0.1)

    ratio_fn = torch.where(depth > 1e-6, depth_next / torch.clamp(depth, min=1e-6), 0.0)
    ratio_nf = torch.where(depth_next > 1e-6, depth / torch.clamp(depth_next, min=1e-6), 0.0)
    lat_far = torch.linalg.norm(p * ratio_fn[..., None] - nxt, dim=-1) / torch.clamp(depth_next, min=1e-6)
    lat_near = torch.linalg.norm(nxt * ratio_nf[..., None] - p, dim=-1) / torch.clamp(depth, min=1e-6)
    trig_far = jump & (depth > depth_next) & (lat_far < 0.1)     # suppress i-half..i
    trig_near = jump & (depth <= depth_next) & (lat_near < 0.1)  # suppress i+1..i+half+1

    blocked = torch.zeros_like(valid)
    for d in range(0, half + 1):
        blocked = blocked | torch.roll(trig_far, -d, dims=1)
    for d in range(1, half + 2):
        blocked = blocked | torch.roll(trig_near, d, dims=1)

    dis = torch.sum(p * p, dim=-1)
    ramp_k = (4.0 * (2.0 * math.pi / p.shape[1])) ** 2     # 2e-4 at the VLP-16's 1800 columns
    ramp = valid & v_nxt & v_prv & (diff_next > ramp_k * dis) & (diff_prev > ramp_k * dis)
    return blocked | ramp


def _greedy_pick(score, eligible, suppressed, gap, num_regions: int, region_w: int, picks: int,
                 promote_first: int, label_hi: int, label_lo: int, half: int = 5):
    """`picks` rounds of greedy picking with markAsPicked suppression: each
    round every region takes its best unsuppressed candidate (the first of
    equal scores, as `argmax` takes in both frameworks); the pick and up to
    `half` ring neighbours on each side are suppressed, the wave stopping at
    the first gap. The first `promote_first` picks get `label_hi`, the rest
    `label_lo`. Regions pick simultaneously per round, as in the JAX
    function."""
    rings = score.shape[0]
    W = num_regions * region_w
    dev = score.device
    flat_score = score.reshape(rings, num_regions, region_w)
    col_base = torch.arange(num_regions, device=dev) * region_w
    row = torch.arange(rings, device=dev)[:, None].expand(rings, num_regions)
    label = torch.zeros((rings, W), dtype=torch.int32, device=dev)
    supp = suppressed
    for k in range(picks):
        cand = (eligible & ~supp).reshape(rings, num_regions, region_w)
        cand_score = torch.where(cand, flat_score, float("-inf"))
        best = torch.argmax(cand_score, dim=-1)
        best_ok = torch.gather(cand_score, -1, best[..., None])[..., 0] > float("-inf")
        oh = torch.zeros((rings, W), dtype=torch.bool, device=dev)
        oh[row, col_base[None, :] + best] = best_ok            # one column per region
        label = torch.where(oh, label_hi if k < promote_first else label_lo, label)
        supp = supp | oh
        run_r = run_l = oh
        for _ in range(half):
            run_r = torch.roll(run_r, 1, dims=1) & ~gap
            run_l = torch.roll(run_l, -1, dims=1) & ~torch.roll(gap, -1, dims=1)
            supp = supp | run_r | run_l
    return label, supp


def extract_features(
    cloud: PointCloud,
    width: int = 1024,
    num_regions: int = 6,
    sharp_per_region: int = 2,
    less_sharp_per_region: int = 20,
    flat_per_region: int = 4,
    curvature_threshold: float = 0.1,
    suppression_half: int = 5,
) -> FeatureGrid:
    """Label the grid cells SHARP/LESS_SHARP/FLAT/LESS_FLAT with LOAM's
    per-region budgets, exclusions and neighbour suppression."""
    if cloud.mask.dim() != 1:
        raise NotImplementedError("batched LOAM feature extraction: ROADMAP A15b")
    grid_xyz, valid, src_idx = _compact_rings(*to_range_image(cloud, width, return_index=True))
    curv, cvalid = compute_curvature(grid_xyz, valid)
    blocked = unreliable_mask(grid_xyz, valid, half=suppression_half)

    usable = width - width % num_regions
    region_w = usable // num_regions
    c = curv[:, :usable]
    v = cvalid[:, :usable] & ~blocked[:, :usable]
    gap_full = (
        torch.sum((grid_xyz - torch.roll(grid_xyz, 1, dims=1)) ** 2, dim=-1) > 0.05
    ) | ~valid | ~torch.roll(valid, 1, dims=1)
    gap = gap_full[:, :usable]

    # corners: descending curvature above the threshold
    corner_elig = v & (c >= curvature_threshold) & torch.isfinite(c)
    corner_label, supp = _greedy_pick(
        c, corner_elig, torch.zeros_like(corner_elig), gap, num_regions, region_w,
        picks=less_sharp_per_region, promote_first=sharp_per_region,
        label_hi=SHARP, label_lo=LESS_SHARP, half=suppression_half,
    )
    # flats: ascending curvature below it; the suppression carries over
    flat_elig = v & (c < curvature_threshold)
    flat_label, _ = _greedy_pick(
        -c, flat_elig, supp, gap, num_regions, region_w,
        picks=flat_per_region, promote_first=flat_per_region,
        label_hi=FLAT, label_lo=FLAT, half=suppression_half,
    )
    label_u = torch.maximum(corner_label, flat_label)
    below = cvalid[:, :usable] & (c < curvature_threshold) & (label_u == NONE)
    label_u = torch.where(below, LESS_FLAT, label_u)

    label = torch.zeros((RINGS, width), dtype=torch.int32, device=grid_xyz.device)
    label[:, :usable] = label_u
    return FeatureGrid(xyz=grid_xyz, valid=valid, curvature=curv, label=label, src_idx=src_idx)


def feature_clouds(fg: FeatureGrid, edge_capacity: int = 512, planar_capacity: int = 2048,
                   source: PointCloud | None = None) -> tuple[PointCloud, PointCloud]:
    """Flatten the label grid into edge (SHARP/LESS_SHARP) and planar
    (FLAT/LESS_FLAT) clouds; with `source`, each feature point carries its
    source point's normal and intensity."""
    xyz = fg.xyz.reshape(-1, 3)
    lab = fg.label.reshape(-1)
    valid = fg.valid.reshape(-1)
    normals = intensity = None
    if source is not None:
        idx = torch.clamp(fg.src_idx.reshape(-1), 0, source.capacity - 1).to(torch.int64)
        normals = source.normals[idx]
        intensity = source.intensity[idx]
    edge = PointCloud.from_points(
        xyz, capacity=xyz.shape[0], mask=valid & ((lab == SHARP) | (lab == LESS_SHARP)),
        normals=normals, intensity=intensity,
    ).compact(edge_capacity)
    planar = PointCloud.from_points(
        xyz, capacity=xyz.shape[0], mask=valid & ((lab == FLAT) | (lab == LESS_FLAT)),
        normals=normals, intensity=intensity,
    ).compact(planar_capacity)
    return edge, planar
