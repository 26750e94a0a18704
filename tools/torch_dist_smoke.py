#!/usr/bin/env python3
"""Multi-process smoke of the PyTorch port's sharded deployments (the copy
of tools/dist_smoke.py on locus_tpu_torch): N processes, one rank each,
form a torch.distributed process group and a ("data", "map") mesh, and run

  --mode sum          a rank-ordered gather of every rank's values and the
                      host-role feeding check (`local_batch_slice`);
  --mode pipeline     one sequence through runner.make_scan_replay(mesh=)
                      with the map split over the ranks, against the
                      unsharded replay (poses within 1e-4 m, map sizes
                      equal; 0.0 expected);
  --mode ckpt_save    the first --resume-at scans of that replay, then each
                      rank saves only its shards and exits (the kill);
  --mode ckpt_resume  fresh ranks restore their files and replay the rest,
                      against the uninterrupted replay (bit for bit);
  --mode dp           runner.make_batched_replay(mesh=): the robots split
                      over the data rows (each rank packs only its own,
                      `local_batch_slice`), each robot's map over the map
                      columns, each robot against its unsharded replay;
  --mode live         live.LiveSession(mesh=) scan by scan, the pose-graph
                      backend on every rank closing loops with
                      optimize(mesh=) and pushing them back through each
                      shard's re-anchor, against an unsharded session.

Run one process per rank (a FileStore rendezvous needs no port):

  python tools/torch_dist_smoke.py --mode pipeline --device cpu \\
      --world-size 2 --rank 0 --init-file /tmp/store &
  python tools/torch_dist_smoke.py --mode pipeline --device cpu \\
      --world-size 2 --rank 1 --init-file /tmp/store

or all of them at once with --launch N. Rank 0 prints one JSON line: the
mode's result with every rank's record under "ranks". --seq/--ref replace
the default sequence and the in-process unsharded reference with files
(`Sequence.save` npz; an npz of "poses" and "sizes"); --profile small runs
tests/test_pipeline.py's small_cfg, ci tools/live_endurance.py --ci's
shapes, production the production protocol of chip_smoke.py, scaling
tools/scaling_bench.py's default shapes. --count-collectives (pipeline
modes) counts every `gather_ranked` call a scan with the bytes it moves
(tools/torch_collective_budget.py). Imports neither JAX nor the JAX
package.
"""
import argparse
import contextlib
import json
import os
import sys
import time

import _pathsetup  # noqa: F401
import numpy as np


def tiny_pipeline_config(cfg_mod):
    """tools/dist_smoke.py's config: a map of 2 x 1 BT chunk a shard, GICP
    in both stages, keyframes and the map sliding window on."""
    return cfg_mod.LocusConfig(
        scan_capacity=256,
        raw_scan_capacity=1024,
        points_to_process_in_callback=220,
        filtering=cfg_mod.FilterConfig(normals_k=8),
        mapper=cfg_mod.MapperConfig(map_capacity=4096, keyframe_capacity=256, map_voxel_leaf=0.1),
        fusion=cfg_mod.FusionConfig(data_integration_mode=0),
    )


def ci_config(cfg_mod):
    """tools/live_endurance.py --ci's config: 1024-point scans, 8192-point
    raw sweeps, an 8192-slot map (2 shards of 2 BT chunks)."""
    return cfg_mod.LocusConfig(
        scan_capacity=1024, raw_scan_capacity=8192, points_to_process_in_callback=800,
        filtering=cfg_mod.FilterConfig(normals_k=12),
        mapper=cfg_mod.MapperConfig(map_capacity=1 << 13, keyframe_capacity=1024, map_voxel_leaf=0.15),
    )


def scaling_config(cfg_mod):
    """tools/scaling_bench.py's default shapes: 512-point scans, 2048-point
    raw sweeps, a 4096-slot map."""
    return cfg_mod.LocusConfig(
        scan_capacity=512, raw_scan_capacity=2048, points_to_process_in_callback=400,
        filtering=cfg_mod.FilterConfig(normals_k=8),
        mapper=cfg_mod.MapperConfig(map_capacity=4096, keyframe_capacity=512, map_voxel_leaf=0.1),
    )


def small_config(cfg_mod):
    """tests/test_pipeline.py's small_cfg: 1024-point scans, 4096-point
    raw sweeps, an 8192-slot map."""
    return cfg_mod.LocusConfig(
        scan_capacity=1024, raw_scan_capacity=4096, points_to_process_in_callback=800,
        filtering=cfg_mod.FilterConfig(body_filter=True, normals_k=12),
        mapper=cfg_mod.MapperConfig(map_capacity=8192, keyframe_capacity=1024, map_voxel_leaf=0.1),
    )


def config(args):
    import dataclasses

    import chip_smoke
    from locus_tpu_torch import config as cfg_mod

    profiles = {"tiny": tiny_pipeline_config, "small": small_config, "ci": ci_config,
                "scaling": scaling_config, "production": cfg_mod.production_config}
    cfg = profiles[args.profile](cfg_mod)
    if args.structure:
        cfg = cfg.replace(mapper=dataclasses.replace(cfg.mapper, structure=args.structure))
    if args.map_capacity:
        cfg = cfg.replace(mapper=dataclasses.replace(cfg.mapper, map_capacity=args.map_capacity))
    if args.msw_box:
        # a small sliding window whose refresh fires (and evicts) within a
        # few scans: the velocity gates disarmed (tests/test_parallel.py)
        cfg = cfg.replace(mapper=dataclasses.replace(
            cfg.mapper, box_filter_size=args.msw_box, translation_threshold_msw=1.5,
            translational_velocity_threshold=1e9, rotational_velocity_threshold=1e9))
    if args.mode == "live":
        cfg = chip_smoke.serving_config(cfg)
    return cfg


def sequence_count(args) -> int:
    if args.seq:
        return len(args.seq.split(","))
    return args.robots if args.mode == "dp" else 1


def sequences(args, which=None):
    """The sequences `which` (default: all) of --seq, or the default
    tunnels (seed, seed + 1, ...)."""
    from locus_tpu_torch.io.dataset import Sequence, make_tunnel_sequence

    which = range(sequence_count(args)) if which is None else which
    if args.seq:
        paths = args.seq.split(",")
        return [Sequence.load(paths[b]) for b in which]
    return [make_tunnel_sequence(num_scans=args.scans, azimuth_steps=args.azimuth, step=args.step, seed=args.seed + b)
            for b in which]


def reference(args, torch, cfg, seqs, dev):
    """(poses (T,[B,]4,4), sizes (T,[B])) of the unsharded replays, from
    --ref or replayed here."""
    if args.ref:
        with np.load(args.ref) as z:
            return z["poses"], z["sizes"] if "sizes" in z else None
    from locus_tpu_torch import pipeline, runner

    poses, sizes = [], []
    for s in seqs:
        st = pipeline.init_state_from_config(cfg, torch.as_tensor(s.gt_poses[0], dtype=torch.float32), device=dev)
        _, (p, _, n) = runner.make_scan_replay(cfg)(st, runner.pack_sequence(s, cfg, device=dev))
        poses.append(p.cpu().numpy())
        sizes.append(n.cpu().numpy())
    if args.mode == "dp":
        return np.stack(poses, axis=1), np.stack(sizes, axis=1)
    return poses[0], sizes[0]


def timing(report, window):
    dur = np.asarray(report.durations)
    w = dur[-window:]
    return {"scans_per_s_last": w.size / float(w.sum()), "window": int(w.size),
            "ms_p50_last": float(np.median(w) * 1e3), "ms_max_last": float(w.max() * 1e3)}


def launches(reset):
    """Reset (reset=True) or read the kernels' launch counters."""
    from locus_tpu_torch.ops.kernels import read_launches, reset_launches

    if reset:
        reset_launches()
        return None
    return read_launches()


@contextlib.contextmanager
def collectives(args, rec, steps):
    """With --trace-collectives, profile the enclosed run on the host and
    put into `rec` the ms a step spent in the mesh's gathers
    (`distributed.gather_ranked`, staging through the host included) and
    their count a step."""
    if not args.trace_collectives:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield
    ev = [e for e in prof.key_averages() if e.key == "gather_ranked"]
    total_us = sum(e.cpu_time_total for e in ev)
    rec["collective_ms_per_step"] = total_us / 1e3 / steps
    rec["collectives_per_step"] = sum(e.count for e in ev) / steps


@contextlib.contextmanager
def counted_collectives(args, rec, steps):
    """With --count-collectives, count every `distributed.gather_ranked`
    call of the enclosed run (each module that calls it is given a counting
    wrapper) and put into `rec` a step's calls, the bytes this rank sends
    and the bytes it receives gathered (its own part included), by the
    (shape, dtype, ranks) of the gathered tensor."""
    if not args.count_collectives:
        yield
        return
    from locus_tpu_torch.mapping import keyframe_map, voxel_hash_map
    from locus_tpu_torch.parallel import distributed, mesh as mesh_mod, posegraph, sharded_map

    callers = (keyframe_map, voxel_hash_map, mesh_mod, posegraph, sharded_map)
    inner = distributed.gather_ranked
    calls = {}

    def counting(x, mesh, axis="map"):
        key = f"{tuple(x.shape)} {str(x.dtype).removeprefix('torch.')} x{mesh.shape[axis]}"
        n = calls.setdefault(key, [0, x.numel() * x.element_size(), mesh.shape[axis]])
        n[0] += 1
        return inner(x, mesh, axis)

    for m in callers:
        m.gather_ranked = counting
    try:
        yield
    finally:
        for m in callers:
            m.gather_ranked = inner
    rec["counted_collectives"] = {
        "steps": steps,
        "calls_per_step": sum(c for c, _, _ in calls.values()) / steps,
        "sent_bytes_per_step": sum(c * b for c, b, _ in calls.values()) / steps,
        "gathered_bytes_per_step": sum(c * b * r for c, b, r in calls.values()) / steps,
        "by_tensor": {k: {"calls": c, "bytes_each": b, "ranks": r} for k, (c, b, r) in calls.items()},
    }


def run_sum(args, torch, mesh, dev):
    from locus_tpu_torch.parallel.distributed import gather_ranked, local_batch_slice

    mine = torch.full((4,), float(mesh.rank), device=dev)
    parts = gather_ranked(mine, mesh, "data")
    total = float(sum(float(p.sum()) for p in parts))
    expect = 4.0 * sum(range(mesh.size))
    if total != expect:
        raise AssertionError((total, expect))
    owned = local_batch_slice(mesh, mesh.shape["data"])
    return {"collective_sum": total, "local_batch_slice": owned, "global_ranks": mesh.size}


def run_pipeline(args, torch, mesh, cfg, dev):
    from locus_tpu_torch import checkpoint, pipeline, runner
    from locus_tpu_torch.metrics import RateReport
    from locus_tpu_torch.parallel.distributed import fetch_replicated
    from locus_tpu_torch.parallel.mesh import shard_state

    (seq,) = sequences(args)
    cap = cfg.mapper.map_capacity
    packed = runner.pack_sequence(seq, cfg, device=dev)
    replay = runner.make_scan_replay(cfg, mesh=mesh)

    def fresh():
        st = pipeline.init_state_from_config(cfg, torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device=dev)
        return shard_state(mesh, st, cap)

    rec = {"map_shards": mesh.shape["map"]}
    if args.mode == "ckpt_save":
        part = {k: v[: args.resume_at] for k, v in packed.items()}
        state, _ = replay(fresh(), part)
        rec["wrote"] = checkpoint.save_state_sharded(args.ckpt, state, mesh, cap)
        rec["scans_before_kill"] = args.resume_at
        return rec
    ref_poses, ref_sizes = reference(args, torch, cfg, [seq], dev)
    if args.mode == "ckpt_resume":
        state = checkpoint.load_state_sharded(args.ckpt, fresh(), mesh, cap)
        packed = {k: v[args.resume_at:] for k, v in packed.items()}
        ref_poses = ref_poses[args.resume_at:]
        ref_sizes = None if ref_sizes is None else ref_sizes[args.resume_at:]
        rec["resumed_scans"] = int(packed["seq_ids"].shape[0])
    else:
        state = fresh()
    report = RateReport()
    launches(reset=True)
    t0 = time.perf_counter()
    steps = packed["seq_ids"].shape[0]
    with collectives(args, rec, steps), counted_collectives(args, rec, steps):
        state, (poses, _, sizes) = replay(state, packed, report=report)
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = launches(reset=False)
    poses, sizes = fetch_replicated(poses), fetch_replicated(sizes)
    n = poses.shape[0]
    rec |= timing(report, args.window) | {
        "scans": n, "launches_per_scan": {k: v / n for k, v in rec["launches"].items()},
        "max_pose_err": float(np.abs(poses - ref_poses[:n]).max()),
        "max_translation_err_m": float(np.abs(poses[:, :3, 3] - ref_poses[:n, :3, 3]).max()),
        "bit_equal": bool(np.array_equal(poses, ref_poses[:n])),
        "map_sizes_equal": None if ref_sizes is None else bool(np.array_equal(sizes, ref_sizes[:n])),
        "final_map_size": int(sizes[-1]), "map_sizes": sizes.tolist(),
        "local_map_points": int(state.map.cloud.count()), "map_operand_rows": int(state.map.nn_aug.shape[0]),
    }
    if args.out and mesh.rank == 0:
        np.savez(f"{args.out}/{args.mode}_poses.npz", poses=poses, sizes=sizes)
    return rec


def run_dp(args, torch, mesh, cfg, dev):
    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.metrics import RateReport
    from locus_tpu_torch.parallel.distributed import fetch_replicated, local_batch_slice
    from locus_tpu_torch.parallel.mesh import shard_state

    owned = local_batch_slice(mesh, sequence_count(args))
    seqs = sequences(args, owned)          # this rank loads, packs and builds only its own robots
    cap = cfg.mapper.map_capacity
    packed = runner.stack_packed([runner.pack_sequence(s, cfg, device=dev) for s in seqs])
    states = pipeline.stack_states([
        shard_state(mesh, pipeline.init_state_from_config(
            cfg, torch.as_tensor(s.gt_poses[0], dtype=torch.float32), device=dev), cap)
        for s in seqs])
    ref_poses, _ = reference(args, torch, cfg, seqs, dev)
    if args.ref:
        ref_poses = ref_poses[:, owned]
    report = RateReport()
    launches(reset=True)
    t0 = time.perf_counter()
    states, (poses, _, sizes) = runner.make_batched_replay(cfg, mesh=mesh)(states, packed, report=report)
    wall = time.perf_counter() - t0
    counts = launches(reset=False)
    poses = fetch_replicated(poses)
    T = poses.shape[0]
    errs = [float(np.abs(poses[:, i] - ref_poses[:T, i]).max()) for i in range(len(owned))]
    return timing(report, args.window) | {
        "owned_rows": owned, "ticks": T, "wall_s": wall, "launches": counts,
        "launches_per_tick": {k: v / T for k, v in counts.items()},
        "max_pose_err_per_robot": errs, "max_pose_err": max(errs),
        "max_translation_err_m": float(np.abs(poses[..., :3, 3] - ref_poses[:T, ..., :3, 3]).max()),
        "bit_equal": bool(np.array_equal(poses, ref_poses[:T])),
        "final_map_sizes": sizes[-1].cpu().numpy().tolist(),
        "map_operand_rows": int(states.map.nn_aug.shape[-2]),
    }


def serve(args, torch, cfg, seq, dev, mesh=None):
    """One LiveSession over `seq` (IMU and odometry fed ahead of each scan),
    with the pose-graph backend closing loops every OPTIMIZE_EVERY
    keyframes when --closures: (poses, latencies s, closure scans,
    backend)."""
    import chip_smoke
    from locus_tpu_torch import runner
    from locus_tpu_torch.backend import PoseGraphBackend
    from locus_tpu_torch.config import RegistrationConfig
    from locus_tpu_torch.live import LiveSession

    sess = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0], device=dev, mesh=mesh)
    backend = PoseGraphBackend(registration=RegistrationConfig(**chip_smoke.LOOP_REGISTRATION), device=dev,
                               **chip_smoke.LOOP_BACKEND)
    has_sensors = seq.imu_stamps is not None
    feeds = chip_smoke.sensor_feeds(np, seq) if has_sensors else None
    poses, lat, pushes, keyframes = [], [], [], 0
    for i in range(len(seq)):
        t0 = time.perf_counter()
        if has_sensors:
            (i0, i1), (o0, o1) = feeds[i]
            for k in range(i0, i1):
                sess.feed_imu(seq.imu_stamps[k], seq.imu_quats[k])
            for k in range(o0, o1):
                sess.feed_odom(seq.odom_stamps[k], seq.odom_poses[k])
        pose, out = sess.process_scan(float(seq.stamps[i]), seq.scans[i], seq.scan_valid[i])
        lat.append(time.perf_counter() - t0)
        poses.append(np.asarray(pose, np.float64))
        if args.closures and out.keyframe_inserted:
            xyz, mask = runner.pack_scan(seq.scans[i], seq.scan_valid[i], cfg.raw_scan_capacity)
            cloud = runner.verification_cloud(torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev), cfg)
            backend.add_keyframe(float(seq.stamps[i]), pose, cloud=cloud)
            keyframes += 1
            if keyframes % chip_smoke.OPTIMIZE_EVERY == 0 and backend.try_close_loops() > 0:
                backend.optimize(mesh=mesh)
                sess.apply_loop_closure(backend.correction_for_latest(), backend.last_corrections)
                pushes.append(i)
    return np.stack(poses), np.asarray(lat), pushes, backend


def run_live(args, torch, mesh, cfg, dev):
    from locus_tpu_torch.metrics import ate_rmse

    (seq,) = sequences(args)
    launches(reset=True)
    poses, lat, pushes, backend = serve(args, torch, cfg, seq, dev, mesh)
    counts = launches(reset=False)
    if args.ref:
        with np.load(args.ref) as z:
            ref = z["poses"]
    else:
        ref = serve(args, torch, cfg, seq, dev)[0]
    first = pushes[0] if pushes else len(seq) - 1     # poses up to the first push-back match
    lat_ms = lat * 1e3
    return {
        "scans": len(seq), "closures_pushed_back": len(pushes), "push_back_scans": pushes,
        "loops_found": backend.loops_found, "solves": backend.solves,
        "max_translation_err_before_first_closure_m": float(np.abs(poses[: first + 1, :3, 3] - ref[: first + 1, :3, 3]).max()),
        "max_pose_err_before_first_closure": float(np.abs(poses[: first + 1] - ref[: first + 1]).max()),
        "max_translation_err_m": float(np.abs(poses[:, :3, 3] - ref[:, :3, 3]).max()),
        "ate_m": float(ate_rmse(poses[:, :3, 3], seq.gt_poses[: len(seq), :3, 3], align=False)),
        "latency_ms_p50": float(np.median(lat_ms)), "latency_ms_max": float(lat_ms.max()),
        "slowest_scans": np.argsort(lat_ms)[::-1][:5].tolist(),
        "launches": counts, "launches_per_scan": {k: v / len(seq) for k, v in counts.items()},
    }


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)     # ranks share the host's cores
    from locus_tpu_torch.parallel.distributed import destroy, init_distributed
    from locus_tpu_torch.parallel.mesh import make_mesh

    if args.device == "cuda":
        torch.cuda.set_device(0)
    init = f"file://{os.path.abspath(args.init_file)}" if args.init_file else None
    init_distributed(init_method=init, world_size=args.world_size, rank=args.rank, backend=args.backend,
                     timeout_s=args.timeout)
    default_map = 1 if args.mode in ("sum", "dp") else args.world_size
    mesh = make_mesh(args.world_size, map_parallel=args.map_parallel or default_map, device_type=args.device,
                     backend=args.backend)
    dev = mesh.device
    try:
        if args.mode == "sum":
            rec = run_sum(args, torch, mesh, dev)
        elif args.mode == "dp":
            rec = run_dp(args, torch, mesh, config(args), dev)
        elif args.mode == "live":
            rec = run_live(args, torch, mesh, config(args), dev)
        else:
            rec = run_pipeline(args, torch, mesh, config(args), dev)
        rec["rank"] = mesh.rank
        records = [None] * mesh.size
        dist.all_gather_object(records, rec)
    finally:
        destroy()
    if mesh.rank == 0:
        head = {"mode": args.mode, "processes": mesh.size, "mesh": mesh.shape, "device": str(dev),
                "backend": args.backend}
        if dev.type == "cuda":
            head["device_name"] = torch.cuda.get_device_name(0)
        print(json.dumps(head | summary(args.mode, records) | {"ranks": records}), flush=True)
    return 0


def summary(mode, records):
    """The mode's result over every rank: rank 0's values, and where each
    rank checked its own rows (dp) or results (the rest), all of them."""
    r0 = records[0]
    if mode == "sum":
        return {k: r0[k] for k in ("collective_sum", "local_batch_slice")}
    if mode == "ckpt_save":
        return {"scans_before_kill": r0["scans_before_kill"], "wrote": [r["wrote"] for r in records]}
    if mode == "live":
        return {k: r0[k] for k in ("closures_pushed_back", "ate_m", "max_translation_err_before_first_closure_m",
                                    "max_pose_err_before_first_closure", "max_translation_err_m")} | {
            "ranks_agree": all(r["ate_m"] == r0["ate_m"] for r in records)}
    out = {"max_pose_err": max(r["max_pose_err"] for r in records), "bit_equal": all(r["bit_equal"] for r in records)}
    if mode == "dp":
        return out | {k: [r[k] for r in records] for k in ("owned_rows", "final_map_sizes")}
    return out | {k: r0[k] for k in ("final_map_size", "resumed_scans") if k in r0} | {
        "map_sizes_equal": all(r["map_sizes_equal"] is not False for r in records),
        "map_sizes_agree_across_ranks": all(r["map_sizes"] == r0["map_sizes"] for r in records)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sum", "pipeline", "ckpt_save", "ckpt_resume", "dp", "live"), default="sum")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world-size", type=int)
    ap.add_argument("--init-file", help="FileStore rendezvous path shared by the ranks")
    ap.add_argument("--launch", type=int, help="start this many local ranks of this command and wait for them")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--map-parallel", type=int, help="map columns of the mesh (default: all ranks; dp and sum: 1)")
    ap.add_argument("--profile", choices=("tiny", "small", "ci", "scaling", "production"), default="tiny")
    ap.add_argument("--structure", choices=("ring", "voxel_hash"))
    ap.add_argument("--map-capacity", type=int)
    ap.add_argument("--msw-box", type=float, help="a small sliding window that evicts within a few scans")
    ap.add_argument("--seq", help="comma-separated Sequence npz files (default: tunnels of --scans/--azimuth/--step)")
    ap.add_argument("--ref", help="npz of the unsharded run's poses (and sizes); default: replayed here")
    ap.add_argument("--scans", type=int, default=8)
    ap.add_argument("--azimuth", type=int, default=128)
    ap.add_argument("--step", type=float, default=0.35)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--robots", type=int, default=2, help="dp: robots (sequences seed, seed+1, ...)")
    ap.add_argument("--closures", action="store_true", help="live: the pose-graph backend closes loops")
    ap.add_argument("--ckpt", default="locus_ckpt", help="checkpoint path prefix of the ckpt_* modes")
    ap.add_argument("--resume-at", type=int, default=4)
    ap.add_argument("--window", type=int, default=32, help="scans (ticks) of the rate window")
    ap.add_argument("--trace-collectives", action="store_true",
                    help="pipeline modes: profile the replay and report the ms a scan in the gathers")
    ap.add_argument("--count-collectives", action="store_true",
                    help="pipeline modes: count the gathers a scan and the bytes they move")
    ap.add_argument("--out", help="directory for rank 0's poses")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds before the ranks are ended")
    args = ap.parse_args()

    if args.launch:
        from locus_tpu_torch.parallel.distributed import spawn_ranks

        argv = [a for a in sys.argv[1:]]
        i = argv.index("--launch")
        del argv[i: i + 2]
        work = args.out or "."
        results = spawn_ranks([sys.executable, __file__, *argv], args.launch, f"{work}/ranks", args.timeout)
        for r, (rc, out, err) in enumerate(results):
            if rc != 0:
                print(f"rank {r} exited {rc}:\n{err[-3000:]}", file=sys.stderr)
                return 1
        sys.stdout.write(results[0][1])
        return 0
    if args.rank is None or args.world_size is None:
        ap.error("--rank and --world-size (or --launch N) are required")
    return rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
