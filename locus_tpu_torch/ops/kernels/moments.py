"""Exact radius moments: kernels B1, B4, B5 and B6 (`csrc/moments.cu`),
their plain PyTorch version, and the pruning that builds the visit lists.

Counterpart of `locus_tpu/ops/pallas/moments.py`. For each query the
kernels sum, over the targets within radius r, the raw moments
[x, y, z, xx, yy, zz, xy, xz, yz, 1]; mean and covariance follow outside
the kernels. The gate is the expanded (|t|^2 - 2 q.t) + |q|^2 <= r^2 of the
JAX kernels.

- B1 (`moments_visits`) and B4 (`moments_visits_batched`), the production
  normals path (`radius_moments_pallas_pruned_comps`): query tiles and
  MBT-point target chunks are pruned by their bounding boxes exactly as in
  `ops/kernels/nn.py`. B4 serves B members in one launch, each with its
  own radius.
- B5 (`moments_dense`) and B6 (`moments_dense_batched`), the dense check
  (`radius_moments_pallas_comps`): every 1024-point chunk, no pruning.

Every function takes one leading batch dimension or none (the B-less call
is the single path). The wrappers pick their path from the tensors'
device: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel (inside `dispatch.no_kernels()`, the plain version).

B1/B4 split each query tile over SPLIT[0] blocks by queries (a grid fixed
by the shapes: no visit count read, so no host synchronisation; no merge).
Whatever the split or the batch, a query's sums combine in one order: per
QUARTER of each visited chunk in list order, then the four quarters as
((P0 + P1) + (P2 + P3)), so a B4 member equals B1 bit for bit.

B5/B6 split each tile's targets, by quads of 4, over DENSE_SPLIT[0]
blocks (quads j, j + S, ... to block j: a grid also fixed by the shapes),
whose float64 partials the last block of the tile adds in split order in
the same launch (`_merge_counters`: int counters per device and stream,
so launches that may run at once never share them; zeroed once here and
left at 0 by every launch; the partials go to scratch allocated per
call). The kernel needs no visit lists; the plain version gets every
chunk on every list (`dense_visits`).
"""
from __future__ import annotations

import ctypes

import torch

from locus_tpu_torch.ops import dispatch
from locus_tpu_torch.ops.kernels.nn import (
    BQ,
    _check_operand,
    _device_buffers,
    _row_blocks,
    check_tiling,
    chunk_boxes,
    sq_norm3,
    tile_boxes,
    visit_columns,
    visit_lists,
    visited_mask,
)

MBT = 512        # target chunk of the pruned moments pass
DENSE_BT = 1024  # target chunk of the dense pass (the JAX kernel's BT)
NM = 10          # moment columns
PAD_T2 = 1e12    # |t|^2 of padding targets: fails every gate
QUARTER = MBT // 4  # targets of one fixed partial of B1/B4 (one warp's share of a chunk)
# The instance B1/B4 launch (QUERY_SPLITS, WARPS of csrc/moments.cu): each
# tile to two blocks of 32 queries, 4 warps a quarter of a chunk (512
# threads, one octet of queries a warp). The fastest instance at both B1's
# 64 tiles and B4's 4 x 64 on the H100 (tools/torch_moments_ab.py sweeps
# the others; PERF.md).
SPLIT = (2, 4)
# The instance B5/B6 launch (DENSE_SPLITS, DENSE_OCTETS of csrc/moments.cu):
# each tile's quads of 4 targets over 8 blocks (quads j, j + 8, ... to
# block j), 4 octets of queries a warp (256 threads a block).
DENSE_SPLIT = (8, 4)


def moments_visits_plain(cnt, ids, r2, q, t, bt: int = MBT):
    """Plain PyTorch version of kernels B1/B4 (and, with every chunk on
    every list, B5/B6): the same visit lists, gate and outputs ((..., n_pad,
    10) raw sums). `r2` holds one radius per member ((1,) or (B,)). The f32
    features are summed in float64 and rounded once, as in the kernels, so
    the two agree bit for bit."""
    n_pad, m_pad = q.shape[-2], t.shape[-2]
    lead = q.shape[:-2]
    visit = visited_mask(cnt, ids, m_pad // bt)
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    feat = torch.stack(
        [x, y, z, x * x, y * y, z * z, x * y, x * z, y * z, torch.ones_like(x)], dim=-1
    ).double()
    r2 = r2.reshape(lead + (1, 1))
    out = torch.empty(lead + (n_pad, NM), dtype=torch.float32, device=q.device)
    tt = t[..., None, :, :]
    for r0, r1 in _row_blocks(n_pad, lead.numel() * m_pad):
        qb = q[..., r0:r1, :]
        score = (
            tt[..., 3]
            + qb[..., 0:1] * (-2.0 * tt[..., 0])
            + qb[..., 1:2] * (-2.0 * tt[..., 1])
            + qb[..., 2:3] * (-2.0 * tt[..., 2])
        )
        W = visit_columns(visit, r0, r1, bt) & (score + qb[..., 3:4] <= r2)
        out[..., r0:r1, :] = (W.double() @ feat).float()
    return out


def launch_grid(kind: str, batch: int, num_tiles: int):
    """((x, y, z) grid, threads a block) of a moments launch: `kind`
    "visits" (B1/B4: tile parts, members) or "dense" (B5/B6: tiles,
    members, target splits)."""
    if kind == "dense":
        splits, octets = DENSE_SPLIT
        return (num_tiles, batch, splits), 1024 // octets
    qs, warps = SPLIT
    return (num_tiles * qs, batch, 1), 128 * warps


def _merge_counters(dev: torch.device, num_counters: int) -> torch.Tensor:
    """The int counters of B5/B6's in-launch merge on `dev`'s current
    stream (one a member's tile), at least `num_counters`: zeroed once,
    left at 0 by every launch. Each stream has its own, so launches that
    may overlap (on two streams) never count on the same counter."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _device_buffers(dev, num_counters, f"dense moments on stream {stream:#x}")[1]


def dense_scratch(batch: int, num_tiles: int, splits: int, device) -> torch.Tensor:
    """Scratch of a B5/B6 launch: a float64 (BQ, NM) partial for each split
    of each member's tile."""
    return torch.empty(batch * num_tiles * splits * BQ * NM, dtype=torch.float64, device=device)


def _moments_cuda(kind, cnt, ids, r2, q, t, bt: int, batched: bool):
    """Launch B1/B4 (`kind` "visits") or B5/B6 ("dense": `cnt` and `ids`
    None, the kernel visits every target) on the card."""
    from locus_tpu_torch.ops.kernels import build, count_launch

    dense = kind == "dense"
    dev = q.device
    lists = ((cnt, "cnt", torch.int32, None), (ids, "ids", torch.int32, None)) if cnt is not None else ()
    for x, name, dtype, cols in ((q, "q", torch.float32, 4), (t, "t", torch.float32, 4), *lists,
                                 (r2, "r2", torch.float32, None)):
        _check_operand(x, name, dtype, cols, dev)
    batch = q.shape[0] if batched else 1
    entry = f"locus_moments_{kind}" + ("_batched" if batched else "")
    num_tiles, num_chunks = check_tiling(entry, q, t, cnt, ids, batch, bt, batched)
    if r2.shape != (batch,):
        raise ValueError(f"{entry}: r2 {tuple(r2.shape)}, expected ({batch},)")
    fn = getattr(build.library("moments"), entry)
    pointers = (q, t) if dense else (q, t, cnt, ids)
    sizes = ((batch,) if batched else ()) + (num_tiles, num_chunks, bt)
    # B5/B6: the split partials' scratch and the merge counters
    merge = ()
    if dense:
        merge = (dense_scratch(batch, num_tiles, DENSE_SPLIT[0], dev), _merge_counters(dev, batch * num_tiles))
    fn.argtypes = ([ctypes.c_void_p] * (len(pointers) + 1) + [ctypes.c_int] * len(sizes)
                   + [ctypes.c_void_p] * (len(merge) + 2))
    fn.restype = ctypes.c_int
    out = torch.empty(q.shape[:-1] + (NM,), dtype=torch.float32, device=dev)
    status = fn(
        *(p.data_ptr() for p in pointers), r2.data_ptr(), *sizes, *(m.data_ptr() for m in merge),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, entry)
    count_launch("moments_" + ("dense" if dense else "visits") + ("_batched" if batched else ""))
    return out


def moments_visits(cnt, ids, r2, q, t, bt: int = MBT):
    """Raw radius moments (n_pad, 10) of each packed query of one member
    over the targets of its tile's visited chunks (kernel B1); r2 (1,)."""
    if q.is_cuda and dispatch.kernels_enabled():
        return _moments_cuda("visits", cnt, ids, r2, q, t, bt, batched=False)
    return moments_visits_plain(cnt, ids, r2, q, t, bt)


def moments_visits_batched(cnt, ids, r2, q, t, bt: int = MBT):
    """Kernel B1 for B members in one launch (kernel B4): cnt (B, G), ids
    (B, G*C), r2 (B,) one radius per member, q (B, n_pad, 4), t (B, m_pad,
    4) -> (B, n_pad, 10)."""
    if q.is_cuda and dispatch.kernels_enabled():
        return _moments_cuda("visits", cnt, ids, r2, q, t, bt, batched=True)
    return moments_visits_plain(cnt, ids, r2, q, t, bt)


def dense_visits(q: torch.Tensor, t: torch.Tensor):
    """The visit lists of the dense pass: every tile visits every
    DENSE_BT-chunk, in order."""
    num_tiles, num_chunks = q.shape[-2] // BQ, t.shape[-2] // DENSE_BT
    lead = q.shape[:-2]
    cnt = torch.full(lead + (num_tiles,), num_chunks, dtype=torch.int32, device=q.device)
    ids = torch.arange(num_chunks, dtype=torch.int32, device=q.device).repeat(num_tiles)
    return cnt, ids.expand(lead + ids.shape).contiguous()


def moments_dense(r2, q, t):
    """Dense raw radius moments (n_pad, 10) of one member over every
    target (kernel B5; the dense check of B1); r2 (1,)."""
    if q.is_cuda and dispatch.kernels_enabled():
        return _moments_cuda("dense", None, None, r2, q, t, DENSE_BT, batched=False)
    return moments_visits_plain(*dense_visits(q, t), r2, q, t, DENSE_BT)


def moments_dense_batched(r2, q, t):
    """Kernel B5 for B members in one launch (kernel B6): r2 (B,), q (B,
    n_pad, 4), t (B, m_pad, 4) -> (B, n_pad, 10)."""
    if q.is_cuda and dispatch.kernels_enabled():
        return _moments_cuda("dense", None, None, r2, q, t, DENSE_BT, batched=True)
    return moments_visits_plain(*dense_visits(q, t), r2, q, t, DENSE_BT)


def pack_operands(query: torch.Tensor, target: torch.Tensor, bt: int = MBT):
    """(..., N, 3), (..., M, 3) -> q (..., n_pad, 4) [x, y, z, |q|^2] and
    t (..., m_pad, 4) [x, y, z, |t|^2], target rows padded to a multiple of
    `bt` with padding targets at |t|^2 = PAD_T2."""
    n, m = query.shape[-2], target.shape[-2]
    q = torch.zeros(query.shape[:-2] + (-(-n // BQ) * BQ, 4), dtype=torch.float32, device=query.device)
    q[..., :n, :3] = query
    q[..., :n, 3] = sq_norm3(query)
    t = torch.zeros(target.shape[:-2] + (-(-m // bt) * bt, 4), dtype=torch.float32, device=target.device)
    t[..., :m, :3] = target
    t[..., :m, 3] = sq_norm3(target)
    t[..., m:, 3].fill_(PAD_T2)
    return q, t


def prune(query: torch.Tensor, target: torch.Tensor, r2):
    """Visit lists (cnt, ids) of the query tiles against the MBT-chunks of
    `target` at squared radius r2 (batched: one value or one per member);
    sentinel points (|coord| >= 1e7) are left out of the boxes."""
    m_pad = -(-target.shape[-2] // MBT) * MBT
    c_min, c_max = chunk_boxes(
        target, torch.all(target.abs() < 1e7, dim=-1), m_pad, bt=MBT
    )
    t_min, t_max = tile_boxes(query)
    return visit_lists(t_min, t_max, c_min, c_max, r2)


def _radius_r2(query: torch.Tensor, radius) -> torch.Tensor:
    """Squared radius as one f32 per member: (1,) single, (B,) batched."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=query.device)
    r2 = r * r
    return r2.reshape(1) if query.dim() == 2 else r2.expand(query.shape[:1]).contiguous()


def radius_moments_pruned_comps(query: torch.Tensor, target: torch.Tensor, radius):
    """Box-pruned exact radius moments in component form (counterpart of
    `radius_moments_pallas_pruned_comps`; batched, of its vmap): (count
    (..., N), (mx, my, mz), (cxx, cxy, cxz, cyy, cyz, czz)). `radius` may be
    a 0-d tensor, or batched a (B,) tensor of per-member radii. Runs kernel
    B1, batched B4."""
    r2 = _radius_r2(query, radius)
    cnt, ids = prune(query, target, r2)
    q, t = pack_operands(query, target)
    run = moments_visits_batched if query.dim() == 3 else moments_visits
    out = run(cnt, ids, r2, q, t)
    return moments_to_comps(out[..., : query.shape[-2], :])


def radius_moments_comps(query: torch.Tensor, target: torch.Tensor, radius):
    """Dense exact radius moments in component form (counterpart of
    `radius_moments_pallas_comps`; batched, of its vmap). Runs kernel B5,
    batched B6."""
    r2 = _radius_r2(query, radius)
    q, t = pack_operands(query, target, bt=DENSE_BT)
    run = moments_dense_batched if query.dim() == 3 else moments_dense
    return moments_to_comps(run(r2, q, t)[..., : query.shape[-2], :])


def radius_moments(query: torch.Tensor, target: torch.Tensor, radius):
    """Dense-layout form of `radius_moments_comps` (counterpart of
    `radius_moments_pallas`): (count (..., N), mean (..., N, 3), cov
    (..., N, 3, 3))."""
    count, (mx, my, mz), (cxx, cxy, cxz, cyy, cyz, czz) = radius_moments_comps(query, target, radius)
    mean = torch.stack([mx, my, mz], dim=-1)
    cov = torch.stack(
        [torch.stack([cxx, cxy, cxz], dim=-1),
         torch.stack([cxy, cyy, cyz], dim=-1),
         torch.stack([cxz, cyz, czz], dim=-1)],
        dim=-2,
    )
    return count, mean, cov


def moments_to_comps(out: torch.Tensor):
    """(..., N, >=10) raw moment columns -> (count, mean comps, cov comps).

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
    count = out[..., 9]
    denom = torch.clamp(count, min=1.0)
    mx, my, mz = out[..., 0] / denom, out[..., 1] / denom, out[..., 2] / denom

    def cov(col, a, b):
        e = (out[..., col] / denom).double()
        return (e - a.double() * b.double()).float()

    return count, (mx, my, mz), (
        cov(3, mx, mx), cov(6, mx, my), cov(7, mx, mz),
        cov(4, my, my), cov(8, my, mz), cov(5, mz, mz),
    )
