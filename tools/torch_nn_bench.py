#!/usr/bin/env python3
"""Map-ANN microbenchmark of the port (tools/nn_bench.py on
locus_tpu_torch): kernel B2 (`csrc/nn.cu` through
ops/kernels/nn.nearest_bounded_scores) at production shapes against the
target chunk size, with the visit statistics of its box pruning.

The map is tools/nn_bench.py:57-88's ring store: numpy seed 0, --map-kf
keyframes of 4096 points on a 4 m-radius tunnel shell 1 m apart, in a
131072-slot store (padding rows at 1e8 m); the query is
4096 points on the shell around the last keyframe, sorted by their 0.3 m voxel key as the
voxel grid leaves a scan. `--operand voxel_hash` puts the same keyframes
into the voxel-hash map (mapping/voxel_hash_map.py at 0.15 m voxels), whose
slots are hashes of their voxels: every chunk spans the whole window.

For each chunk size of --bt (512, 1024, 2048) it reports
- the visit statistics of the 64-query tiles at the 2 m search radius:
  visited chunks per tile (mean, max), the visited pairs (queries x
  targets the kernel scans) and the share of (tile, chunk) pairs visited;
- the kernel alone (`kernel_ms`: the B2 launch on prebuilt visit lists)
  and the whole call (`call_ms`: tile boxes, visit lists, the launch, the
  winners' distances), median of --reps CUDA-event timings of device
  time (each call queued behind a sleep kernel); every timed
  launch is held against `nn_visits_plain` on the same inputs, score bits
  and index on every row (`bit_equal`);
- a probe against brute force on every 64th query (`near_exact`).
--shards S runs tools/nn_bench.py:98-130's per-shard case: the store cut
into S contiguous shards (insertion order), the kernel timed on each.
The port has no LOCUS_NN_BT variable: `bt` is an argument of the call, so
every size runs in this one process.

    python tools/torch_nn_bench.py [--bt 512,1024,2048] [--map-kf 32] [--shards 1]
        [--operand ring|voxel_hash] [--reps 20] [--device cpu] [--json out]

Runs on the CUDA device unless --device cpu (the plain version, timed on
the host). Imports neither JAX nor the JAX package.
"""
import argparse
import json
import time

import _torch_tool
import numpy as np

M_CAP = 1 << 17
KF_POINTS = 4096
QUERIES = 4096
RADIUS = 2.0
PAD = 1e8


def _shell(rng, center_x: float, n: int) -> np.ndarray:
    theta = rng.uniform(0, 2 * np.pi, n)
    x = rng.uniform(-6.0, 6.0, n)
    r = 4.0 + rng.normal(0, 0.02, n)
    return np.stack([center_x + x, r * np.cos(theta), r * np.sin(theta)], axis=1)


def ring_store(map_kf: int, m_cap: int = M_CAP):
    """(map (m_cap, 3) f32, mask (m_cap,), query (QUERIES, 3) f32): the
    ring-store layout of tools/nn_bench.py, the same draws."""
    rng = np.random.default_rng(0)
    pts = [_shell(rng, k * 1.0, KF_POINTS) for k in range(map_kf)]
    map_xyz = np.concatenate(pts).astype(np.float32)[:m_cap]
    m = map_xyz.shape[0]
    map_full = np.concatenate([map_xyz, np.full((m_cap - m, 3), PAD, np.float32)])
    mask = np.concatenate([np.ones(m, bool), np.zeros(m_cap - m, bool)])
    query = _shell(rng, map_kf - 1.0, QUERIES).astype(np.float32)
    key = np.floor(query / 0.3).astype(np.int64)
    return map_full, mask, query[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]


def voxel_hash_store(map_full, mask, dev):
    """The ring store's points inserted keyframe by keyframe into the
    voxel-hash map of as many slots: (xyz, mask) of its slots."""
    import torch

    from locus_tpu_torch.config import MapperConfig
    from locus_tpu_torch.core.cloud import PointCloud
    from locus_tpu_torch.mapping import voxel_hash_map

    cfg = MapperConfig(map_capacity=map_full.shape[0], keyframe_capacity=KF_POINTS, map_voxel_leaf=0.15,
                       structure="voxel_hash")
    st = voxel_hash_map.init_map(cfg, device=dev)
    pts = map_full[mask]
    for k in range(0, pts.shape[0], KF_POINTS):
        st = voxel_hash_map.insert_keyframe(st, PointCloud.from_points(pts[k:k + KF_POINTS], capacity=KF_POINTS,
                                                                       device=dev), cfg)
    return st.cloud.xyz.cpu().numpy(), st.cloud.mask.cpu().numpy()


def _time_ms(torch, fn, dev, reps: int) -> tuple:
    """(median ms, the results of every timed call): on the card the device
    time between CUDA events, each call queued behind a sleep kernel so that
    the host's enqueue is not timed; on the CPU the host's clock."""
    fn()
    times, results = [], []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            results.append(fn())
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            results.append(fn())
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), results


def visit_stats(cnt, num_chunks: int, bt: int) -> dict:
    """Visit statistics of a call's visit lists."""
    from locus_tpu_torch.ops.kernels.nn import BQ

    c = cnt.double()
    return {
        "tiles": int(cnt.numel()), "chunks": num_chunks,
        "visited_chunks_per_tile_mean": float(c.mean()), "visited_chunks_per_tile_max": int(cnt.max()),
        "visited_chunks": int(cnt.sum()), "visited_pairs": int(cnt.sum()) * BQ * bt,
        "share_of_chunks_visited": float(c.sum()) / (cnt.numel() * num_chunks),
    }


def bench_operand(map_xyz, map_mask, query, bt: int, reps: int, dev) -> dict:
    """One (operand, bt) row: visit statistics, kernel and call times, and
    every timed launch against the plain version."""
    import torch

    from locus_tpu_torch.ops.kernels import nn as tnn

    mq = torch.from_numpy(map_xyz).to(dev)
    msk = torch.from_numpy(map_mask).to(dev)
    qd = torch.from_numpy(query).to(dev)
    t_aug = tnn.build_nn_target(mq, bt=bt)
    c_min, c_max = tnn.chunk_boxes(mq, msk, t_aug.shape[0], bt=bt)
    cnt, ids = tnn.visit_lists(*tnn.tile_boxes(qd), c_min, c_max, RADIUS * RADIUS)
    q = tnn.pack_query(qd)
    row = {"bt": bt, "map_points": int(map_mask.sum()), "operand_rows": int(t_aug.shape[0])}
    row |= visit_stats(cnt, t_aug.shape[0] // bt, bt)
    before = sum(_torch_tool.launch_counts().values())
    row["kernel_ms"], outs = _time_ms(torch, lambda: tnn.nn_visits(cnt, ids, q, t_aug, bt), dev, reps)
    row["call_ms"], _ = _time_ms(
        torch, lambda: tnn.nearest_bounded_scores(qd, t_aug, mq, c_min, c_max, RADIUS, bt=bt), dev, reps)
    row["kernel_launches"] = sum(_torch_tool.launch_counts().values()) - before
    ps, pi = tnn.nn_visits_plain(cnt, ids, q, t_aug, bt)
    score_bits = sum(int((s.view(torch.int32) != ps.view(torch.int32)).sum()) for s, _ in outs)
    index_diff = sum(int((i != pi).sum()) for _, i in outs)
    row |= {"route": "cuda" if dev.type == "cuda" else "plain", "timed_launches_checked": len(outs),
            "score_bit_mismatches": score_bits, "index_mismatches": index_diff,
            "bit_equal": score_bits == 0 and index_diff == 0}
    # brute force on every 64th query: the bounded search must find a
    # neighbour at least as near wherever one lies within the radius
    _, d2, _ = tnn.nearest_bounded_scores(qd, t_aug, mq, c_min, c_max, RADIUS, bt=bt)
    sub = np.arange(0, query.shape[0], 64)
    pts = map_xyz[map_mask]
    d_ref = (np.min(np.sum((query[sub][:, None, :] - pts[None, :, :]) ** 2, axis=2), axis=1) if len(pts)
             else np.full(sub.size, np.inf))          # an empty shard
    d_got = d2.cpu().numpy()[sub]
    near = d_ref <= RADIUS * RADIUS
    row["near_exact"] = bool(np.all(np.isfinite(d_got[near])) and np.all(d_got[near] <= d_ref[near] + 3e-4))
    return row


def nn_bench(map_kf: int, bts, reps: int, dev, shards: int = 1, operand: str = "ring", m_cap: int = M_CAP) -> dict:
    """Every row of the benchmark: one per bt, or per (bt, shard)."""
    map_full, mask, query = ring_store(map_kf, m_cap)
    if operand == "voxel_hash":
        map_full, mask = voxel_hash_store(map_full, mask, dev)
    _torch_tool.reset_launches()                 # the sweep's launches
    rows = []
    for bt in bts:
        if shards == 1:
            rows.append(bench_operand(map_full, mask, query, bt, reps, dev))
            continue
        local = m_cap // shards
        per = [bench_operand(map_full[s * local:(s + 1) * local], mask[s * local:(s + 1) * local], query, bt,
                             reps, dev) | {"shard": s} for s in range(shards)]
        rows.append({"bt": bt, "shards": shards, "local_points": local, "per_shard": per,
                     "per_shard_kernel_ms": [r["kernel_ms"] for r in per],
                     "max_shard_kernel_ms": max(r["kernel_ms"] for r in per),
                     "sum_shard_kernel_ms": sum(r["kernel_ms"] for r in per),
                     "bit_equal": all(r["bit_equal"] for r in per)})
    return {"operand": operand, "map_kf": map_kf, "map_capacity": m_cap, "queries": QUERIES, "radius": RADIUS,
            "shards": shards, "rows": rows, "bit_equal": all(r["bit_equal"] for r in rows),
            "launches": _torch_tool.launch_counts()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bt", default="512,1024,2048")
    ap.add_argument("--map-kf", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shards", type=int, default=1,
                    help="time the kernel on each of this many contiguous shards of the store")
    ap.add_argument("--operand", choices=("ring", "voxel_hash"), default="ring")
    _torch_tool.add_device_arg(ap)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    dev = _torch_tool.device(args.device)
    result = nn_bench(args.map_kf, [int(b) for b in args.bt.split(",")], args.reps, dev, args.shards,
                      args.operand) | _torch_tool.device_record(dev)
    print(json.dumps(result), flush=True)
    _torch_tool.write_json(args.json, result)
    return 0 if result["bit_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
