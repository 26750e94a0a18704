"""Box-pruned exact radius moments: kernel B1 (`csrc/moments.cu`), its
plain PyTorch version, and the pruning that builds its visit lists.

Counterpart of `locus_tpu/ops/pallas/moments.py` (the production
scan-normals path, `radius_moments_pallas_pruned_comps`). For each query
the kernel sums, over the targets within radius r, the raw moments
[x, y, z, xx, yy, zz, xy, xz, yz, 1]; mean and covariance follow outside
the kernel. The gate is the expanded (|t|^2 - 2 q.t) + |q|^2 <= r^2 of the
JAX kernel. Query tiles and target chunks are pruned by their bounding
boxes exactly as in `ops/kernels/nn.py` (visited chunks are those whose box
lies within r of the tile's box), with MBT-point chunks.

The wrapper `moments_visits` picks its path from the tensors' device: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel
(inside `dispatch.no_kernels()`, the plain version).
"""
from __future__ import annotations

import ctypes

import torch

from locus_tpu_torch.ops import dispatch
from locus_tpu_torch.ops.kernels.nn import (
    BQ,
    _check_operand,
    _row_blocks,
    chunk_boxes,
    tile_boxes,
    visit_lists,
    visited_mask,
)

MBT = 512   # target chunk of the pruned moments pass
NM = 10     # moment columns
PAD_T2 = 1e12  # |t|^2 of padding targets: fails every gate

# Launches of the CUDA kernel since the last reset (plain runs not counted).
launches = 0


def moments_visits_plain(cnt, ids, r2, q, t, bt: int = MBT):
    """Plain PyTorch version of the kernel: the same visit lists, gate and
    outputs ((n_pad, 10) raw sums). The f32 features are summed in float64
    and rounded once, as in the kernel, so the two agree bit for bit."""
    n_pad, m_pad = q.shape[0], t.shape[0]
    visit = visited_mask(cnt, ids, m_pad // bt)
    x, y, z = t[:, 0], t[:, 1], t[:, 2]
    feat = torch.stack(
        [x, y, z, x * x, y * y, z * z, x * y, x * z, y * z, torch.ones_like(x)], dim=1
    )
    out = torch.empty((n_pad, NM), dtype=torch.float32, device=q.device)
    for r0, r1 in _row_blocks(n_pad, m_pad):
        qb = q[r0:r1]
        score = (
            t[None, :, 3]
            + qb[:, 0:1] * (-2.0 * t[None, :, 0])
            + qb[:, 1:2] * (-2.0 * t[None, :, 1])
            + qb[:, 2:3] * (-2.0 * t[None, :, 2])
        )
        cols = visit[r0 // BQ : r1 // BQ].repeat_interleave(BQ, 0).repeat_interleave(bt, 1)
        W = (cols & (score + qb[:, 3:4] <= r2)).to(torch.float32)
        out[r0:r1] = (W.double() @ feat.double()).float()
    return out


def _moments_visits_cuda(cnt, ids, r2, q, t, bt: int = MBT):
    global launches
    from locus_tpu_torch.ops.kernels import build

    dev = q.device
    for x, name, dtype, cols in (
        (q, "q", torch.float32, 4), (t, "t", torch.float32, 4),
        (cnt, "cnt", torch.int32, None), (ids, "ids", torch.int32, None),
        (r2, "r2", torch.float32, None),
    ):
        _check_operand(x, name, dtype, cols, dev)
    n_pad, m_pad = q.shape[0], t.shape[0]
    num_tiles, num_chunks = n_pad // BQ, m_pad // bt
    if (n_pad % BQ or m_pad % bt or cnt.shape != (num_tiles,)
            or ids.numel() != num_tiles * num_chunks or r2.numel() != 1):
        raise ValueError(
            f"moments_visits: q {tuple(q.shape)}, t {tuple(t.shape)}, cnt "
            f"{tuple(cnt.shape)}, ids {tuple(ids.shape)}, r2 {tuple(r2.shape)} "
            f"do not tile by BQ={BQ}, bt={bt}"
        )
    lib = build.library("moments")
    fn = lib.locus_moments_visits
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.empty((n_pad, NM), dtype=torch.float32, device=dev)
    status = fn(
        q.data_ptr(), t.data_ptr(), cnt.data_ptr(), ids.data_ptr(), r2.data_ptr(),
        num_tiles, num_chunks, bt, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "locus_moments_visits")
    launches += 1
    return out


def moments_visits(cnt, ids, r2, q, t, bt: int = MBT):
    """Raw radius moments (n_pad, 10) of each packed query over the
    targets of its tile's visited chunks."""
    if q.is_cuda and dispatch.kernels_enabled():
        return _moments_visits_cuda(cnt, ids, r2, q, t, bt)
    return moments_visits_plain(cnt, ids, r2, q, t, bt)


def pack_operands(query: torch.Tensor, target: torch.Tensor):
    """(N,3), (M,3) -> q (n_pad, 4) [x, y, z, |q|^2] and t (m_pad, 4)
    [x, y, z, |t|^2] with padding targets at |t|^2 = PAD_T2."""
    n, m = query.shape[0], target.shape[0]
    q = torch.zeros((-(-n // BQ) * BQ, 4), dtype=torch.float32, device=query.device)
    q[:n, :3] = query
    q[:n, 3] = torch.sum(query * query, dim=1)
    t = torch.zeros((-(-m // MBT) * MBT, 4), dtype=torch.float32, device=target.device)
    t[:m, :3] = target
    t[:m, 3] = torch.sum(target * target, dim=1)
    t[m:, 3] = PAD_T2
    return q, t


def prune(query: torch.Tensor, target: torch.Tensor, r2):
    """Visit lists (cnt, ids) of the query tiles against the MBT-chunks of
    `target` at squared radius r2; sentinel points (|coord| >= 1e7) are
    left out of the boxes."""
    m_pad = -(-target.shape[0] // MBT) * MBT
    c_min, c_max = chunk_boxes(
        target, torch.all(target.abs() < 1e7, dim=1), m_pad, bt=MBT
    )
    t_min, t_max = tile_boxes(query)
    return visit_lists(t_min, t_max, c_min, c_max, r2)


def radius_moments_pruned_comps(query: torch.Tensor, target: torch.Tensor, radius):
    """Box-pruned exact radius moments in component form (counterpart of
    `radius_moments_pallas_pruned_comps`): (count (N,), (mx, my, mz),
    (cxx, cxy, cxz, cyy, cyz, czz)). `radius` may be a 0-d tensor."""
    r2 = radius * radius
    cnt, ids = prune(query, target, r2)
    q, t = pack_operands(query, target)
    r2_t = torch.as_tensor(r2, dtype=torch.float32, device=query.device).reshape(1)
    out = moments_visits(cnt, ids, r2_t, q, t)
    return moments_to_comps(out[: query.shape[0]])


def moments_to_comps(out: torch.Tensor):
    """(N,>=10) raw moment columns -> (count, mean comps, cov comps).

    f32 note: the one-pass E[xx^T] - m m^T form carries an absolute
    error ~eps*|x|^2 (~4e-5 at 20 m sensor range). That is fine HERE:
    normal-estimation neighborhoods span >= the voxel leaf, so the true
    variance (>= ~2.5e-3) dominates and the normal direction moves < 1
    degree. It is NOT fine for NDT voxel Gaussians, whose variance can
    be 1e-5 — registration/ndt.py uses two-pass centered moments for
    that reason. If this kernel is ever pointed at world-frame clouds
    hundreds of meters from the origin, revisit (error grows as |x|^2).

    Each E[ab] - ma mb is rounded once, as the fused multiply-add that
    XLA emits for it does: the f32 operands go through float64, where the
    product is exact. At the sub-millimetre variances of thin neighbourhoods
    the second rounding of a plain f32 product-then-subtract is enough to
    turn the normal."""
    count = out[:, 9]
    denom = torch.clamp(count, min=1.0)
    mx, my, mz = out[:, 0] / denom, out[:, 1] / denom, out[:, 2] / denom

    def cov(col, a, b):
        e = (out[:, col] / denom).double()
        return (e - a.double() * b.double()).float()

    return count, (mx, my, mz), (
        cov(3, mx, mx), cov(6, mx, my), cov(7, mx, mz),
        cov(4, my, my), cov(8, my, mz), cov(5, mz, mz),
    )
