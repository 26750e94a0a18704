"""Visit-list exact 1-NN: kernel B2 (`csrc/nn.cu`), its plain PyTorch
version, and the box pruning that builds its visit lists.

Counterpart of `locus_tpu/ops/pallas/nn.py`. With
    t_aug = [-2x, -2y, -2z, |t|^2]      (m_pad, 4), one row per target
the score |t|^2 - 2 q.t = |q - t|^2 - |q|^2 shares its argmin with the true
distance. The exact distance of each winner is recomputed from the gathered
coordinates. The operand is one 16-byte row per target (the JAX package
keeps the transposed (8, m_pad) layout its TPU tiles want;
`convert.py` maps one to the other).

Pruning: per query tile (BQ queries) and per target chunk (bt targets) an
axis-aligned bounding box; a tile visits a chunk when the two boxes lie
within the search radius. Every target within the radius of a valid query
lies in a visited chunk, so the bounded search is exact at any tile size.
The visited chunk ids are packed to the front of each tile's row.

The wrapper `nn_visits` picks its path from the tensors' device: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (inside
`dispatch.no_kernels()`, the plain version).
"""
from __future__ import annotations

import ctypes

import torch

from locus_tpu_torch.ops import dispatch

BT = 2048      # map target chunk (the map caches are sized by it)
SCAN_BT = 512  # scan-scale target chunk (GICP against one scan)
BQ = 64        # query tile of the port: one CUDA block
BOX_BIG = 1e9

# Launches of the CUDA kernel since the last reset, by chunk size (each
# size is its own template instance); plain runs are not counted.
launches = {SCAN_BT: 0, BT: 0}


def build_nn_target(target: torch.Tensor, m_pad: int | None = None, bt: int = BT) -> torch.Tensor:
    """(M,3) coordinates -> (m_pad, 4) operand; padding rows never win
    (|t|^2 = +inf)."""
    m = target.shape[0]
    if m_pad is None:
        m_pad = -(-m // bt) * bt
    t = torch.zeros((m_pad, 4), dtype=torch.float32, device=target.device)
    t[:m, :3] = -2.0 * target
    t[:m, 3] = torch.sum(target * target, dim=1)
    t[m:, 3] = float("inf")
    return t


def update_nn_target(
    t_aug: torch.Tensor, idx: torch.Tensor, xyz: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Write K points into the operand at rows `idx`; rows with
    valid=False are dropped (they land on a scratch row that is cut off)."""
    m_pad = t_aug.shape[0]
    rows = torch.cat([-2.0 * xyz, torch.sum(xyz * xyz, dim=1, keepdim=True)], dim=1)
    ext = torch.cat([t_aug, t_aug.new_zeros((1, 4))], dim=0)
    safe = torch.where(valid, idx.to(torch.int64), m_pad)
    return ext.index_copy(0, safe, rows)[:m_pad]


def chunk_boxes(
    target: torch.Tensor, target_mask: torch.Tensor, m_pad: int | None = None, bt: int = BT
):
    """Per-chunk bounding boxes over valid targets: (c_min (C,3),
    c_max (C,3)). A chunk with no valid point gets (+BOX_BIG, -BOX_BIG),
    which every box test rejects."""
    m = target.shape[0]
    if m_pad is None:
        m_pad = -(-m // bt) * bt
    tc = torch.zeros((m_pad, 3), dtype=torch.float32, device=target.device)
    tc[:m] = target
    mc = torch.zeros((m_pad,), dtype=torch.bool, device=target.device)
    mc[:m] = target_mask
    tc = tc.view(m_pad // bt, bt, 3)
    mc = mc.view(m_pad // bt, bt, 1)
    c_min = torch.where(mc, tc, BOX_BIG).amin(dim=1)
    c_max = torch.where(mc, tc, -BOX_BIG).amax(dim=1)
    return c_min, c_max


def update_chunk_boxes(c_min, c_max, idx, xyz, valid, bt: int = BT):
    """Grow chunk boxes to cover K points written at rows `idx` (invalid
    writes ignored). Boxes only grow until the next exact rebuild: a
    larger box only visits more, never misses a point."""
    num_chunks = c_min.shape[0]
    cid = torch.where(valid, idx.to(torch.int64) // bt, num_chunks)[:, None].expand(-1, 3)
    lo = torch.where(valid[:, None], xyz, BOX_BIG)
    hi = torch.where(valid[:, None], xyz, -BOX_BIG)
    pad = c_min.new_zeros((1, 3))
    new_min = torch.cat([c_min, pad]).scatter_reduce(0, cid, lo, "amin")[:num_chunks]
    new_max = torch.cat([c_max, pad]).scatter_reduce(0, cid, hi, "amax")[:num_chunks]
    return new_min, new_max


def tile_boxes(points: torch.Tensor, bq: int = BQ):
    """Per-tile bounding boxes over valid (|coord| < 1e7) points:
    (t_min (G,3), t_max (G,3)), tiles of `bq` rows."""
    n = points.shape[0]
    n_pad = -(-n // bq) * bq
    p = torch.zeros((n_pad, 3), dtype=torch.float32, device=points.device)
    p[:n] = points
    v = torch.zeros((n_pad,), dtype=torch.bool, device=points.device)
    v[:n] = torch.all(points.abs() < 1e7, dim=1)
    p = p.view(n_pad // bq, bq, 3)
    v = v.view(n_pad // bq, bq, 1)
    return torch.where(v, p, BOX_BIG).amin(dim=1), torch.where(v, p, -BOX_BIG).amax(dim=1)


def visit_lists(t_min, t_max, c_min, c_max, r2):
    """Box-gap test of every (tile, chunk) pair at squared radius `r2`;
    returns (cnt (G,) int32, ids (G*C,) int32): tile g visits chunks
    ids[g*C : g*C + cnt[g]], in ascending order. Unused slots hold 0."""
    gap = torch.clamp(
        torch.maximum(c_min[None] - t_max[:, None], t_min[:, None] - c_max[None]), min=0.0
    )
    visit = torch.sum(gap * gap, dim=-1) <= r2                     # (G, C)
    num_tiles, num_chunks = visit.shape
    cnt = torch.sum(visit, dim=1, dtype=torch.int32)
    # visited chunk c goes to slot cumsum - 1; the rest to a scratch column
    pos = torch.where(visit, torch.cumsum(visit, dim=1) - 1, num_chunks)
    col = torch.arange(num_chunks, device=visit.device).expand(num_tiles, -1)
    ids = torch.zeros((num_tiles, num_chunks + 1), dtype=torch.int64, device=visit.device)
    ids.scatter_(1, pos, col)
    return cnt, ids[:, :num_chunks].to(torch.int32).reshape(-1)


def visited_mask(cnt: torch.Tensor, ids: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """(G, C) bool: which chunks each tile visits, from its visit list."""
    num_tiles = cnt.shape[0]
    used = torch.arange(num_chunks, device=cnt.device)[None, :] < cnt[:, None]
    slot = torch.where(used, ids.view(num_tiles, num_chunks).to(torch.int64), num_chunks)
    mask = torch.zeros((num_tiles, num_chunks + 1), dtype=torch.bool, device=cnt.device)
    mask.scatter_(1, slot, True)
    return mask[:, :num_chunks]


def _row_blocks(num_rows: int, num_cols: int, bq: int = BQ):
    """Row ranges (multiples of bq) whose (rows, num_cols) f32 matrix stays
    near 64 MB."""
    step = max(bq, ((1 << 24) // max(num_cols, 1)) // bq * bq)
    return [(r, min(r + step, num_rows)) for r in range(0, num_rows, step)]


def nn_visits_plain(cnt, ids, q, t_aug, bt: int):
    """Plain PyTorch version of the kernel: the same visit lists, score
    and tie rule (lowest index among the minimal scores). Returns
    (score (n_pad,) f32, idx (n_pad,) int32)."""
    n_pad, m_pad = q.shape[0], t_aug.shape[0]
    visit = visited_mask(cnt, ids, m_pad // bt)
    best_d = torch.empty((n_pad,), dtype=torch.float32, device=q.device)
    best_i = torch.empty((n_pad,), dtype=torch.int32, device=q.device)
    for r0, r1 in _row_blocks(n_pad, m_pad):
        qb = q[r0:r1]
        score = (
            t_aug[None, :, 3]
            + qb[:, 0:1] * t_aug[None, :, 0]
            + qb[:, 1:2] * t_aug[None, :, 1]
            + qb[:, 2:3] * t_aug[None, :, 2]
        )
        cols = visit[r0 // BQ : r1 // BQ].repeat_interleave(BQ, 0).repeat_interleave(bt, 1)
        d, i = torch.min(torch.where(cols, score, float("inf")), dim=1)
        best_d[r0:r1] = d
        best_i[r0:r1] = i.to(torch.int32)
    return best_d, best_i


def _check_operand(x: torch.Tensor, name: str, dtype, cols: int | None, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor on {device}, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )
    if cols is not None and (x.dim() != 2 or x.shape[1] != cols):
        raise ValueError(f"{name}: expected shape (*, {cols}), got {tuple(x.shape)}")


def _nn_visits_cuda(cnt, ids, q, t_aug, bt: int):
    from locus_tpu_torch.ops.kernels import build

    dev = q.device
    for x, name, dtype, cols in (
        (q, "q", torch.float32, 4), (t_aug, "t_aug", torch.float32, 4),
        (cnt, "cnt", torch.int32, None), (ids, "ids", torch.int32, None),
    ):
        _check_operand(x, name, dtype, cols, dev)
    n_pad, m_pad = q.shape[0], t_aug.shape[0]
    num_tiles, num_chunks = n_pad // BQ, m_pad // bt
    if n_pad % BQ or m_pad % bt or cnt.shape != (num_tiles,) or ids.numel() != num_tiles * num_chunks:
        raise ValueError(
            f"nn_visits: q {tuple(q.shape)}, t_aug {tuple(t_aug.shape)}, cnt "
            f"{tuple(cnt.shape)}, ids {tuple(ids.shape)} do not tile by BQ={BQ}, bt={bt}"
        )
    lib = build.library("nn")
    fn = lib.locus_nn_visits
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    d = torch.empty((n_pad,), dtype=torch.float32, device=dev)
    i = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    status = fn(
        q.data_ptr(), t_aug.data_ptr(), cnt.data_ptr(), ids.data_ptr(),
        num_tiles, num_chunks, bt, d.data_ptr(), i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "locus_nn_visits")
    launches[bt] += 1
    return d, i


def nn_visits(cnt, ids, q, t_aug, bt: int):
    """Visit-list 1-NN: (score (n_pad,), idx (n_pad,) int32) of each packed
    query against the operand rows of its tile's visited chunks."""
    if q.is_cuda and dispatch.kernels_enabled():
        return _nn_visits_cuda(cnt, ids, q, t_aug, bt)
    return nn_visits_plain(cnt, ids, q, t_aug, bt)


def pack_query(query: torch.Tensor, bq: int = BQ) -> torch.Tensor:
    """(N,3) -> (n_pad, 4) [x, y, z, 1] rows, zero padding rows."""
    n = query.shape[0]
    q = torch.zeros((-(-n // bq) * bq, 4), dtype=torch.float32, device=query.device)
    q[:n, :3] = query
    q[:n, 3] = 1.0
    return q


def nearest_bounded_pre(
    query: torch.Tensor,
    t_aug: torch.Tensor,
    target: torch.Tensor,
    c_min: torch.Tensor,
    c_max: torch.Tensor,
    radius=2.0,
    bt: int = BT,
):
    """Radius-bounded exact 1-NN against a prebuilt operand and chunk boxes
    (counterpart of `nearest_pallas_bounded_pre`). Returns (d2 (N,),
    idx (N,) int64); queries whose nearest target lies beyond `radius`
    get d2 = +inf. `bt` must be the chunk size the operand and boxes were
    built with."""
    n, m = query.shape[0], target.shape[0]
    r2 = radius * radius
    t_min, t_max = tile_boxes(query)
    cnt, ids = visit_lists(t_min, t_max, c_min, c_max, r2)
    _, i = nn_visits(cnt, ids, pack_query(query), t_aug, bt)
    idx = torch.clamp(i[:n].to(torch.int64), 0, m - 1)
    diff = query - target[idx]
    d2 = torch.sum(diff * diff, dim=1)
    return torch.where(d2 <= r2, d2, float("inf")), idx
