"""Visit-list exact 1-NN: kernels B2 and B3 (`csrc/nn.cu`), their plain
PyTorch version, and the box pruning that builds their visit lists.

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

Batching: every function here also takes one leading batch dimension (the
multi-robot replay, B members each with its own target and visit lists),
the counterpart of the JAX functions under vmap. The B-less call is
the single path. The wrappers pick their path from the tensors' device: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel
(inside `dispatch.no_kernels()`, the plain version). `nn_visits` launches
B2 for one member, `nn_visits_batched` B3 for B members in one launch.

The kernel splits each query tile over blocks by queries and, for a map,
its visited chunks (in slices of SUB targets) over further blocks whose
partial minima are merged in the same launch by the last block to finish;
`splits()` picks both from the shapes. The merge counts blocks in a buffer
of int counters per device, zeroed once here and left at 0 by every
launch; the partial minima go to scratch allocated per call. The pipeline
runs on one stream, and two streams must not launch these kernels at
once: they would share the counters.
"""
from __future__ import annotations

import ctypes

import torch

from locus_tpu_torch.core.cloud import take_rows
from locus_tpu_torch.ops import dispatch
from locus_tpu_torch.utils.linalg import sum_last

BT = 2048      # map target chunk (the map caches are sized by it)
SCAN_BT = 512  # scan-scale target chunk (GICP against one scan)
BQ = 64        # query tile of the port: the unit of a visit list
SUB = 512      # targets of one slice, the unit of work of a B2/B3 block
THREADS = 128  # threads of a B2/B3 block (csrc/nn.cu)
QUERY_SPLITS = (1, 2, 4)  # the kernel's instances: 64, 32 or 16 queries a block
SMALL_TARGET = 8  # a tile of at most this many slices is never split by slices
TARGET_SPLITS = 8  # blocks a map tile's slices are split over
BOX_BIG = 1e9

# Launches of the CUDA kernels since the last reset, by chunk size (each
# size is its own template instance): B2 (`launches`, one member) and B3
# (`batched_launches`, one launch for a batch). Plain runs are not counted.
launches = {SCAN_BT: 0, BT: 0}
batched_launches = {SCAN_BT: 0, BT: 0}


def sq_norm3(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) x^2 + y^2 + z^2, summed left to right (a batch
    member rounds as the single call does)."""
    return sum_last(x * x)


def _pad_dim(x: torch.Tensor, size: int, fill, dim: int) -> torch.Tensor:
    """x padded with `fill` to `size` along `dim`."""
    n = x.shape[dim]
    if size == n:
        return x
    shape = list(x.shape)
    shape[dim] = size - n
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=dim)


def build_nn_target(target: torch.Tensor, m_pad: int | None = None, bt: int = BT) -> torch.Tensor:
    """(..., M, 3) coordinates -> (..., m_pad, 4) operand; padding rows
    never win (|t|^2 = +inf)."""
    m = target.shape[-2]
    if m_pad is None:
        m_pad = -(-m // bt) * bt
    t = torch.zeros(target.shape[:-2] + (m_pad, 4), dtype=torch.float32, device=target.device)
    t[..., :m, :3] = -2.0 * target
    t[..., :m, 3] = sq_norm3(target)
    t[..., m:, 3] = float("inf")
    return t


def update_nn_target(
    t_aug: torch.Tensor, idx: torch.Tensor, xyz: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Write K points into the operand at rows `idx`; rows with
    valid=False are dropped (they land on a scratch row that is cut off)."""
    m_pad = t_aug.shape[-2]
    rows = torch.cat([-2.0 * xyz, sq_norm3(xyz)[..., None]], dim=-1)
    ext = _pad_dim(t_aug, m_pad + 1, 0.0, -2)
    safe = torch.where(valid, idx.to(torch.int64), m_pad)
    return ext.scatter(-2, safe[..., None].expand(rows.shape), rows)[..., :m_pad, :]


def chunk_boxes(
    target: torch.Tensor, target_mask: torch.Tensor, m_pad: int | None = None, bt: int = BT
):
    """Per-chunk bounding boxes over valid targets: (c_min (..., C, 3),
    c_max (..., C, 3)). A chunk with no valid point gets (+BOX_BIG,
    -BOX_BIG), which every box test rejects."""
    m = target.shape[-2]
    if m_pad is None:
        m_pad = -(-m // bt) * bt
    lead = target.shape[:-2]
    tc = _pad_dim(target.to(torch.float32), m_pad, 0.0, -2).reshape(lead + (m_pad // bt, bt, 3))
    mc = _pad_dim(target_mask, m_pad, False, -1).reshape(lead + (m_pad // bt, bt, 1))
    c_min = torch.where(mc, tc, BOX_BIG).amin(dim=-2)
    c_max = torch.where(mc, tc, -BOX_BIG).amax(dim=-2)
    return c_min, c_max


def update_chunk_boxes(c_min, c_max, idx, xyz, valid, bt: int = BT):
    """Grow chunk boxes to cover K points written at rows `idx` (invalid
    writes ignored). Boxes only grow until the next exact rebuild: a
    larger box only visits more, never misses a point."""
    num_chunks = c_min.shape[-2]
    cid = torch.where(valid, idx.to(torch.int64) // bt, num_chunks)[..., None].expand(xyz.shape)
    lo = torch.where(valid[..., None], xyz, BOX_BIG)
    hi = torch.where(valid[..., None], xyz, -BOX_BIG)
    new_min = _pad_dim(c_min, num_chunks + 1, 0.0, -2).scatter_reduce(-2, cid, lo, "amin")
    new_max = _pad_dim(c_max, num_chunks + 1, 0.0, -2).scatter_reduce(-2, cid, hi, "amax")
    return new_min[..., :num_chunks, :], new_max[..., :num_chunks, :]


def tile_boxes(points: torch.Tensor, bq: int = BQ):
    """Per-tile bounding boxes over valid (|coord| < 1e7) points:
    (t_min (..., G, 3), t_max (..., G, 3)), tiles of `bq` rows."""
    n = points.shape[-2]
    n_pad = -(-n // bq) * bq
    lead = points.shape[:-2]
    v = torch.all(points.abs() < 1e7, dim=-1)
    p = _pad_dim(points.to(torch.float32), n_pad, 0.0, -2).reshape(lead + (n_pad // bq, bq, 3))
    v = _pad_dim(v, n_pad, False, -1).reshape(lead + (n_pad // bq, bq, 1))
    return torch.where(v, p, BOX_BIG).amin(dim=-2), torch.where(v, p, -BOX_BIG).amax(dim=-2)


def visit_lists(t_min, t_max, c_min, c_max, r2):
    """Box-gap test of every (tile, chunk) pair at squared radius `r2`;
    returns (cnt (..., G) int32, ids (..., G*C) int32): tile g visits
    chunks ids[g*C : g*C + cnt[g]], in ascending order. Unused slots hold 0.
    Batched, `r2` is one value for all members or a (B,) tensor."""
    gap = torch.clamp(
        torch.maximum(c_min[..., None, :, :] - t_max[..., :, None, :],
                      t_min[..., :, None, :] - c_max[..., None, :, :]),
        min=0.0,
    )
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=gap.device)
    r2 = r2.reshape(r2.shape + (1, 1)) if t_min.dim() == 3 else r2.reshape(())   # (1,) single
    visit = sq_norm3(gap) <= r2                                      # (..., G, C)
    num_chunks = visit.shape[-1]
    cnt = torch.sum(visit, dim=-1, dtype=torch.int32)
    # visited chunk c goes to slot cumsum - 1; the rest to a scratch column
    pos = torch.where(visit, torch.cumsum(visit, dim=-1) - 1, num_chunks)
    col = torch.arange(num_chunks, device=visit.device).expand(visit.shape)
    ids = torch.zeros(visit.shape[:-1] + (num_chunks + 1,), dtype=torch.int64, device=visit.device)
    ids.scatter_(-1, pos, col)
    return cnt, ids[..., :num_chunks].to(torch.int32).flatten(-2)


def visited_mask(cnt: torch.Tensor, ids: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """(..., G, C) bool: which chunks each tile visits, from its visit list."""
    used = torch.arange(num_chunks, device=cnt.device) < cnt[..., None]
    ids = ids.reshape(cnt.shape + (num_chunks,)).to(torch.int64)
    slot = torch.where(used, ids, num_chunks)
    mask = torch.zeros(cnt.shape + (num_chunks + 1,), dtype=torch.bool, device=cnt.device)
    mask.scatter_(-1, slot, True)
    return mask[..., :num_chunks]


def _row_blocks(num_rows: int, num_cols: int, bq: int = BQ):
    """Row ranges (multiples of bq) whose (rows, num_cols) f32 matrix stays
    near 64 MB."""
    step = max(bq, ((1 << 24) // max(num_cols, 1)) // bq * bq)
    return [(r, min(r + step, num_rows)) for r in range(0, num_rows, step)]


def visit_columns(visit: torch.Tensor, r0: int, r1: int, bt: int) -> torch.Tensor:
    """(..., r1 - r0, m_pad) bool: the targets query rows [r0, r1) visit."""
    return visit[..., r0 // BQ : r1 // BQ, :].repeat_interleave(BQ, -2).repeat_interleave(bt, -1)


def nn_visits_plain(cnt, ids, q, t_aug, bt: int):
    """Plain PyTorch version of kernels B2 and B3: the same visit lists,
    score and tie rule (lowest index among the minimal scores). Takes one
    leading batch dimension or none. Returns (score (..., n_pad) f32,
    idx (..., n_pad) int32)."""
    n_pad, m_pad = q.shape[-2], t_aug.shape[-2]
    lead = q.shape[:-2]
    visit = visited_mask(cnt, ids, m_pad // bt)
    best_d = torch.empty(lead + (n_pad,), dtype=torch.float32, device=q.device)
    best_i = torch.empty(lead + (n_pad,), dtype=torch.int32, device=q.device)
    for r0, r1 in _row_blocks(n_pad, lead.numel() * m_pad):
        qb = q[..., r0:r1, :]
        t = t_aug[..., None, :, :]
        score = t[..., 3] + qb[..., 0:1] * t[..., 0] + qb[..., 1:2] * t[..., 1] + qb[..., 2:3] * t[..., 2]
        d, i = torch.min(torch.where(visit_columns(visit, r0, r1, bt), score, float("inf")), dim=-1)
        best_d[..., r0:r1] = d
        best_i[..., r0:r1] = i.to(torch.int32)
    return best_d, best_i


def _check_operand(x: torch.Tensor, name: str, dtype, cols: int | None, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor on {device}, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )
    if cols is not None and x.shape[-1] != cols:
        raise ValueError(f"{name}: expected shape (..., {cols}), got {tuple(x.shape)}")


def check_tiling(what, q, t, cnt, ids, batch, bt: int, batched: bool):
    """Shapes of a (batched) visit-list launch: (num_tiles, num_chunks);
    `cnt` and `ids` None for a launch without visit lists (the dense
    moments). Raises on anything the kernels do not take."""
    rank = 3 if batched else 2
    n_pad, m_pad = q.shape[-2], t.shape[-2]
    num_tiles, num_chunks = n_pad // BQ, m_pad // bt
    lead = (batch,) if batched else ()
    lists = cnt is not None
    if (q.dim() != rank or t.dim() != rank or q.shape[:-2] != lead or t.shape[:-2] != lead
            or n_pad % BQ or m_pad % bt or lists and (cnt.shape != lead + (num_tiles,)
                                                      or ids.shape != lead + (num_tiles * num_chunks,))):
        raise ValueError(
            f"{what}: q {tuple(q.shape)}, t {tuple(t.shape)}"
            + (f", cnt {tuple(cnt.shape)}, ids {tuple(ids.shape)}" if lists else "")
            + f" do not tile by BQ={BQ}, bt={bt}" + (f" over a batch of {batch}" if batched else "")
        )
    return num_tiles, num_chunks


def splits(batch: int, num_tiles: int, num_chunks: int, bt: int, sms: int) -> tuple[int, int]:
    """(query splits, target splits) of a B2/B3 launch, from the shapes
    alone (the visit counts stay on the card). A tile's queries go to as
    many blocks as keep the grid within 2 blocks per SM: that needs no
    merge. Where that leaves one block per tile and a tile may hold more
    than SMALL_TARGET slices (a map), its slices go to TARGET_SPLITS
    blocks, merged in the launch. A merge costs about as much as scanning
    a slice (on the H100), so a scan-sized tile is never split by slices."""
    qs = max(q for q in QUERY_SPLITS if q == 1 or batch * num_tiles * q <= 2 * sms)
    most = num_chunks * (bt // SUB)
    if qs > 1 or most <= SMALL_TARGET:
        return qs, 1
    return 1, min(most, TARGET_SPLITS)


def launch_grid(batch: int, num_tiles: int, num_chunks: int, bt: int, sms: int):
    """The (x, y, z) grid of a B2/B3 launch: tile parts, members, target
    splits."""
    qs, ts = splits(batch, num_tiles, num_chunks, bt, sms)
    return (num_tiles * qs, batch, ts)


# per (CUDA device, buffer family): (SM count, counter buffer of an
# in-launch merge)
_device_state: dict[tuple[torch.device, str], tuple[int, torch.Tensor]] = {}
# counter buffers replaced by larger ones, kept alive for CUDA graphs that
# captured a launch on them
_retired: list[torch.Tensor] = []
# counter buffers made or grown in this process (a server that has warmed
# up allocates none while it serves)
buffer_allocations = 0


def _device_buffers(dev: torch.device, num_counters: int, family: str = "nn"):
    """The SM count of `dev` and the counter buffer `family` on it ("nn":
    B2/B3's; B5/B6 keep one per stream), at least `num_counters` long. The
    buffer is zeroed once, when it is made or grown; every launch leaves it
    at 0."""
    global buffer_allocations
    sms, counters = _device_state.get((dev, family), (None, None))
    if counters is None or counters.numel() < num_counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{family}: the merge counters of this device are not allocated yet; "
                "call the kernel once outside CUDA graph capture first (on the capture stream, "
                "for counters kept per stream)"
            )
        if counters is None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        else:
            _retired.append(counters)
        counters = torch.zeros(max(num_counters, 1 << 14), dtype=torch.int32, device=dev)
        buffer_allocations += 1
        _device_state[(dev, family)] = (sms, counters)
    return sms, counters


def _nn_visits_cuda(cnt, ids, q, t_aug, bt: int, batched: bool, num_splits=None):
    """Launch B2 (one member) or B3 (`batched`) on the card. `num_splits`,
    a (query splits, target splits) pair, overrides `splits()`: the tests
    and tools/torch_nn_ab.py run every grid with it."""
    from locus_tpu_torch.ops.kernels import build

    dev = q.device
    for x, name, dtype, cols in (
        (q, "q", torch.float32, 4), (t_aug, "t_aug", torch.float32, 4),
        (cnt, "cnt", torch.int32, None), (ids, "ids", torch.int32, None),
    ):
        _check_operand(x, name, dtype, cols, dev)
    batch = q.shape[0] if batched else 1
    entry = "locus_nn_visits_batched" if batched else "locus_nn_visits"
    num_tiles, num_chunks = check_tiling(entry, q, t_aug, cnt, ids, batch, bt, batched)
    if bt % SUB:
        raise ValueError(f"{entry}: bt={bt} is not a multiple of the slice, {SUB}")
    sms, counters = _device_buffers(dev, batch * num_tiles * max(QUERY_SPLITS))
    qs, ts = num_splits or splits(batch, num_tiles, num_chunks, bt, sms)
    fn = getattr(build.library("nn"), entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (6 if batched else 5) + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    partial = torch.empty(batch * num_tiles * ts * BQ * 2, dtype=torch.int32, device=dev)
    d = torch.empty(q.shape[:-1], dtype=torch.float32, device=dev)
    i = torch.empty(q.shape[:-1], dtype=torch.int32, device=dev)
    sizes = (batch, num_tiles, num_chunks, bt) if batched else (num_tiles, num_chunks, bt)
    status = fn(
        q.data_ptr(), t_aug.data_ptr(), cnt.data_ptr(), ids.data_ptr(), *sizes, qs, ts,
        partial.data_ptr(), counters.data_ptr(), d.data_ptr(), i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, entry)
    (batched_launches if batched else launches)[bt] += 1
    return d, i


def nn_visits(cnt, ids, q, t_aug, bt: int):
    """Visit-list 1-NN of one member (kernel B2): (score (n_pad,), idx
    (n_pad,) int32) of each packed query against the operand rows of its
    tile's visited chunks."""
    if q.is_cuda and dispatch.kernels_enabled():
        return _nn_visits_cuda(cnt, ids, q, t_aug, bt, batched=False)
    return nn_visits_plain(cnt, ids, q, t_aug, bt)


def nn_visits_batched(cnt, ids, q, t_aug, bt: int):
    """Visit-list 1-NN of B members in one launch (kernel B3): cnt (B, G),
    ids (B, G*C), q (B, n_pad, 4), t_aug (B, m_pad, 4) -> (score (B, n_pad),
    idx (B, n_pad) int32), each member against its own operand."""
    if q.is_cuda and dispatch.kernels_enabled():
        return _nn_visits_cuda(cnt, ids, q, t_aug, bt, batched=True)
    return nn_visits_plain(cnt, ids, q, t_aug, bt)


def pack_query(query: torch.Tensor, bq: int = BQ) -> torch.Tensor:
    """(..., N, 3) -> (..., n_pad, 4) [x, y, z, 1] rows, zero padding rows."""
    n = query.shape[-2]
    q = torch.zeros(query.shape[:-2] + (-(-n // bq) * bq, 4), dtype=torch.float32, device=query.device)
    q[..., :n, :3] = query
    q[..., :n, 3] = 1.0
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
    (counterpart of `nearest_pallas_bounded_pre`; batched, of its vmap).
    Returns (d2 (..., N), idx (..., N) int64); queries whose nearest target
    lies beyond `radius` get d2 = +inf. `bt` must be the chunk size the
    operand and boxes were built with. A leading batch dimension runs
    kernel B3, none kernel B2."""
    n, m = query.shape[-2], target.shape[-2]
    r2 = radius * radius
    t_min, t_max = tile_boxes(query)
    cnt, ids = visit_lists(t_min, t_max, c_min, c_max, r2)
    run = nn_visits_batched if query.dim() == 3 else nn_visits
    _, i = run(cnt, ids, pack_query(query), t_aug, bt)
    idx = torch.clamp(i[..., :n].to(torch.int64), 0, m - 1)
    d2 = sq_norm3(query - take_rows(target, idx))
    return torch.where(d2 <= r2, d2, float("inf")), idx
