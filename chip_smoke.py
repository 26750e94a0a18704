#!/usr/bin/env python3
"""Smoke test of locus_tpu_torch on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs a CUDA
device and the repository's `locus_tpu_torch` package beside this file,
and fails (non-zero exit, no result line) without either. It imports
nothing of JAX or of `locus_tpu`.

Phases, each printing one JSON line:
 1. device     card name and the nvidia-smi power limit
 2. build      nvcc of every kernel source, all at once
 3. reference  the first 8 scans of the production tunnel replay, the
               first 8 ticks of the 4-robot batched replay, and the first 8
               scans of each path of phase 8, with the kernels' plain
               PyTorch versions (`no_kernels()`), on the card
 4. kernels    each kernel at the shapes the main paths give it (inputs
               from the reference runs' states; B5 on B1's inputs, B6 on
               B4's), against its plain version on the same inputs, timed
               with CUDA events beside the plain version, a one-call
               PyTorch yardstick where one exists, and the bound from this
               run's visited pairs and the launch floor of the grid and
               block the wrapper launches (an empty kernel; B5/B6 also
               report their target splits); every kernel
               is held to the plain version's results on every row (B2/B3
               score bits and index, B1/B4-B6 the ten sums). B2 map also
               runs on the voxel-hash operand (from the voxel_hash path's
               reference state). One informational row, B3 map at B = 16
               (the four robots' inputs stacked four times), lies on no path
 5. pipeline   the 48-scan production replay through runner.run_sequence
               with launch counts reset just before and read just after;
               scans/s over the last 32 scans and ATE against ground truth
 6. ab         the pipeline's first 8 poses against the reference run's
 7. batched    4 robots, 24 scans each, through runner.make_batched_replay
               (one batched step per tick) with launch counts reset just
               before and read just after; every robot also through
               runner.make_scan_replay; ticks/s and robot-scans/s over the
               last 16 ticks, per-robot ATE and difference from the single
               replay, launches per tick
 8. ndt, features, voxel_hash
               48 scans of the other single-card paths (`path_config`;
               `path_sequence`: NDT on its source's world tunnel, the
               others on the production tunnel), each with launch counts reset just
               before and read just after: scans/s over the last 32 scans,
               p50 and max latency, ATE, launches per scan by kernel, and
               its first 8 poses against its own plain-version reference
               run (phase 3); B2 must launch on every path, B1 on ndt and
               voxel_hash and not on features (kNN normals)
 9. live       one robot served by live.LiveSession around the 2-lap
               circuit of tools/live_endurance.py (`serve_live`), IMU and
               odometry fed ahead of each scan, the pose-graph backend of
               tools/endurance.py closing loops and pushing them back
               through apply_loop_closure, after the push-back and the
               backend have been prewarmed: per-scan latency (process_scan
               call to pose on the host), keyframes, closures, ATE, final
               error, launches per scan and per closure attempt, kernel
               builds and counter-buffer allocations after the prewarm
               (must be 0); a second session resumed from the checkpoint
               written at scan RESUME_AT must repeat the next 8 poses bit
               for bit; the first 8 poses against a session on the plain
               versions; B2 on the re-anchored map against its plain
               version
10. slam       runner.run_sequence(backend=) on the same circuit at 1800
               azimuth steps (`run_slam`): scans/s, closures, ATE, final
               error, launches per scan; a checkpoint after RESUME_AT scans
               resumed for 8 scans bit for bit; the first 8 poses against
               the plain versions
Then the `kernels` summary line (launches summed over every path), the
nvidia-smi line, and the final `{"ok": true, ...}` line. The full record also goes to
chiprun_out/chip_smoke.json.
"""
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), the roofline of both kernel
# families. fp32 outside the tensor cores: the sheet's 67e12/s counts an FMA
# as two operations; both families issue their multiplies and adds unfused
# (__fmul_rn/__fadd_rn, so that they round as the plain versions do), and
# an unfused multiply, add or compare issues at half that rate. HBM bandwidth.
PEAK_FP32_OPS = 33.5e12
PEAK_BYTES = 3.35e12

SCANS, REF_SCANS, RATE_WINDOW = 48, 8, 32
ROBOTS, ROBOT_SCANS, TICK_WINDOW = 4, 24, 16
ROBOT_STEPS = (0.30, 0.35, 0.40, 0.45)
ATE_LIMIT_M = 0.05
AB_LIMIT_M = 1e-3
BATCHED_LIMIT_M = 1e-3  # each robot of the batched replay against its single replay
# the kernels each replay launches: B1, B2 (scan, map); B4, B3 (scan, map)
SINGLE_PATH = ("moments_visits", "nn_visits_scan", "nn_visits_map")
BATCHED_PATH = ("moments_visits_batched", "nn_visits_batched_scan", "nn_visits_batched_map")
# the other single-card paths (phase 8) and the kernels each must launch:
# B2 always, B1 except on features (kNN normals, no radius moments)
PATHS = {
    "ndt": SINGLE_PATH,
    "features": ("nn_visits_scan", "nn_visits_map"),
    "voxel_hash": SINGLE_PATH,
}
PATH_SCANS = 48
VOXEL_HASH_MAP = "nn_visits_map_voxel_hash"   # the B2 map row on the voxel-hash operand
# The live and slam phases: the circuit of tools/live_endurance.py and
# tools/endurance.py (step 0.5 m, 2 laps, seed 0) cut from 2000 scans to
# CIRCUIT_SCANS; the pose-graph backend at tools/endurance.py:385-392's
# settings, closures tried every OPTIMIZE_EVERY keyframes
CIRCUIT_SCANS, CIRCUIT_STEP, CIRCUIT_LAPS, CIRCUIT_SEED = 240, 0.5, 2, 0
LIVE_AZIMUTH, SLAM_AZIMUTH = 900, 1800
LOOP_BACKEND = {"loop_distance": 4.0, "min_index_gap": 20, "loop_fitness_max": 0.12}
LOOP_REGISTRATION = {"corr_dist": 1.0, "iterations": 40}
OPTIMIZE_EVERY = 5
RESUME_AT, RESUME_SCANS = 40, 8   # checkpoint after scan RESUME_AT - 1, resumed for RESUME_SCANS scans
LATENCY_BUDGET_MS = 100.0         # the pose must arrive before the next 10 Hz sweep


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def production_config(cfg_mod):
    """The production config of bench.py:36-47."""
    return cfg_mod.LocusConfig(
        scan_capacity=4096,
        raw_scan_capacity=32768,
        points_to_process_in_callback=3000,
        filtering=cfg_mod.FilterConfig(normals_k=20),
        mapper=cfg_mod.MapperConfig(map_capacity=1 << 17, keyframe_capacity=4096, map_voxel_leaf=0.15),
    )


def path_config(cfg, name):
    """`cfg` on one of the single-card paths, for the port's LocusConfig or
    the JAX package's alike (the same field names):
    gicp       unchanged (GICP in both stages, the ring map, radius normals)
    ndt        NDT in both stages, irls, direct7 at 1.0 m (the
               configuration of EVAL_NDT_r05.json)
    features   the LOAM features at 1800 columns (the sweep's azimuth
               steps), adaptive covariances in both stages
               (EVAL_FEATURES_r05.json)
    voxel_hash the voxel-hash map in place of the ring"""
    import dataclasses

    rep = dataclasses.replace

    def both_stages(c, **kw):
        return c.replace(odometry=rep(c.odometry, **kw),
                         localization=rep(c.localization, registration=rep(c.localization.registration, **kw)))

    if name == "gicp":
        return cfg
    if name == "ndt":
        return both_stages(cfg, registration_method="ndt", ndt_optimizer="irls", ndt_neighborhood="direct7",
                           ndt_resolution=1.0)
    if name == "features":
        return both_stages(cfg.replace(filtering=rep(cfg.filtering, extract_features=True, feature_width=1800)),
                           covariance_mode="adaptive")
    if name == "voxel_hash":
        return cfg.replace(mapper=rep(cfg.mapper, structure="voxel_hash"))
    raise ValueError(f"unknown path {name!r}")


def path_sequence(dataset, name, seq, num_scans=PATH_SCANS):
    """The replay of a path: `seq`, the production tunnel, except for NDT.
    NDT at 1.0 m voxels drifts on that tunnel in the JAX package too (ATE
    0.1024 m on the CPU, `tools/torch_parity.py --config ndt --tunnel
    production`), so its phase runs on the sequence of its configuration's
    source, EVAL_NDT_r05.json's world tunnel (tools/eval_suite.py)."""
    if name == "ndt":
        return dataset.make_world_sequence("tunnel", num_scans=num_scans, azimuth_steps=900)
    return seq


PATH_SEQUENCE_NAMES = {"ndt": 'make_world_sequence("tunnel", azimuth_steps=900)'}


def serving_config(cfg):
    """`cfg` with the map sliding window's velocity gates raised, as
    tools/endurance.py:171-188 raises them: the simulated robot moves at
    5 m/s, far above the 0.1 m/s "refresh only when slow" heuristic."""
    import dataclasses

    return cfg.replace(mapper=dataclasses.replace(
        cfg.mapper, translational_velocity_threshold=1e3, rotational_velocity_threshold=1e3))


def circuit_sequence(num_scans, azimuth, workers=6, step=CIRCUIT_STEP, laps=CIRCUIT_LAPS, seed=CIRCUIT_SEED):
    """The circuit of tools/endurance.py's build_sequence_streams (world,
    ground truth, IMU and odometry streams) with every scan raycast up
    front, in a thread pool: a port Sequence."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from locus_tpu_torch.io import dataset, synthetic

    world, gt, _ = dataset.circuit_geometry(num_scans, step=step, laps=laps, seed=seed)

    def scan(i):
        return synthetic.simulate_scan(world, gt[i], azimuth_steps=azimuth, noise=0.005, seed=seed + i)

    with ThreadPoolExecutor(workers) as pool:
        scans = list(pool.map(scan, range(num_scans)))
    bare = dataset.Sequence(scans=np.stack([p for p, _ in scans]), scan_valid=np.stack([v for _, v in scans]),
                            stamps=np.arange(num_scans) / 10.0, gt_poses=gt)
    return dataset._with_simulated_sensors(bare, rate_hz=10.0, seed=seed)


def sensor_feeds(np, seq):
    """Per scan, the (start, stop) of the IMU and the odometry samples fed
    ahead of it: those stamped after the previous scan and up to this one
    (tests/test_live.py:34-50, tools/live_endurance.py)."""
    imu = np.searchsorted(seq.imu_stamps, seq.stamps, side="right")
    odo = np.searchsorted(seq.odom_stamps, seq.stamps, side="right")
    return [((imu[i - 1] if i else 0, imu[i]), (odo[i - 1] if i else 0, odo[i])) for i in range(len(seq))]


def launch_delta(tnn, tmom, before):
    return {k: v - before[k] for k, v in read_launches(tnn, tmom).items()}


def add_counts(total, delta):
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v


def trajectory_errors(np, poses, gt):
    from locus_tpu_torch.metrics import ate_rmse

    n = poses.shape[0]
    return ate_rmse(poses[:, :3, 3], gt[:n, :3, 3], align=False), float(np.linalg.norm(poses[-1, :3, 3] - gt[n - 1, :3, 3]))


def serve_live(torch, np, cfg, seq, dev, workdir, resume_at=RESUME_AT, ab_scans=REF_SCANS):
    """One robot served by LiveSession around `seq` with closures pushed
    back (tools/live_endurance.py's loop), after a prewarm of the
    push-back and of the backend's verification GICP and graph solve.
    Returns the phase record and the poses."""
    import shutil

    from locus_tpu_torch import runner
    from locus_tpu_torch.backend import PoseGraphBackend
    from locus_tpu_torch.config import RegistrationConfig
    from locus_tpu_torch.live import LiveSession
    from locus_tpu_torch.ops import dispatch
    from locus_tpu_torch.ops.kernels import build, moments as tmom, nn as tnn

    n, feeds = len(seq), sensor_feeds(np, seq)
    cap = cfg.raw_scan_capacity

    def session(**kw):
        return LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0], device=dev, **kw)

    def serve(sess, i):
        (i0, i1), (o0, o1) = feeds[i]
        for k in range(i0, i1):
            sess.feed_imu(seq.imu_stamps[k], seq.imu_quats[k])
        for k in range(o0, o1):
            sess.feed_odom(seq.odom_stamps[k], seq.odom_poses[k])
        return sess.process_scan(float(seq.stamps[i]), seq.scans[i], seq.scan_valid[i])

    def verification(i):
        xyz, mask = runner.pack_scan(seq.scans[i], seq.scan_valid[i], cap)
        return runner.verification_cloud(torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev), cfg)

    def new_backend():
        return PoseGraphBackend(registration=RegistrationConfig(**LOOP_REGISTRATION), device=dev, **LOOP_BACKEND)

    # prewarm, as tools/live_endurance.py does before serving starts
    warm = session()
    serve(warm, 0)
    warm.prewarm_loop_closure()
    backend = new_backend()
    backend.prewarm(verification(0), iterations=10)   # optimize()'s iteration count
    warmed = (build.builds, len(build._libs), tnn.buffer_allocations)

    ckpt = str(workdir / "live_ckpt.npz")
    sess = session(checkpoint_path=ckpt, checkpoint_every=resume_at)
    per_scan, per_closure = {}, {}
    lat, poses, pushes = [], [], []
    keyframes, attempts = 0, 0
    reset_launches(tnn, tmom)
    t_run = time.perf_counter()
    for i in range(n):
        before = read_launches(tnn, tmom)
        t0 = time.perf_counter()
        pose, out = serve(sess, i)
        lat.append(time.perf_counter() - t0)
        add_counts(per_scan, launch_delta(tnn, tmom, before))
        poses.append(np.asarray(pose, np.float64))
        if i + 1 == resume_at:
            shutil.copy(ckpt, workdir / "live_resume.npz")
        if out.keyframe_inserted:
            before = read_launches(tnn, tmom)
            backend.add_keyframe(float(seq.stamps[i]), pose, cloud=verification(i))
            keyframes += 1
            if keyframes % OPTIMIZE_EVERY == 0:
                attempts += 1
                if backend.try_close_loops() > 0:
                    backend.optimize()
                    sess.apply_loop_closure(backend.correction_for_latest(), backend.last_corrections)
                    pushes.append(i)
            add_counts(per_closure, launch_delta(tnn, tmom, before))
    wall = time.perf_counter() - t_run
    served = (build.builds, len(build._libs), tnn.buffer_allocations)
    poses = np.stack(poses)
    lat_ms = np.asarray(lat) * 1e3
    ate, final = trajectory_errors(np, poses, seq.gt_poses)

    # a second session resumed from the checkpoint repeats the next poses
    resumed = session()
    resumed.resume(str(workdir / "live_resume.npz"))
    again = np.stack([np.asarray(serve(resumed, i)[0], np.float64) for i in range(resume_at, resume_at + RESUME_SCANS)])
    # the first scans on the plain versions
    with dispatch.no_kernels():
        plain = session()
        plain_poses = np.stack([np.asarray(serve(plain, i)[0], np.float64) for i in range(ab_scans)])
    ab = np.abs(poses[:ab_scans, :3, 3] - plain_poses[:, :3, 3]).max(axis=1)
    launches = dict(per_scan)
    add_counts(launches, per_closure)
    record = {
        "phase": "live", "scans": n, "wall_s": wall,
        "latency_ms_p50": float(np.median(lat_ms)), "latency_ms_max": float(lat_ms.max()),
        "latency_ms_per_scan": [round(float(x), 3) for x in lat_ms],
        "latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "share_within_100ms": float(np.mean(lat_ms < LATENCY_BUDGET_MS)),
        "first_scan_ms": float(lat_ms[0]), "keyframes": keyframes, "closure_attempts": attempts,
        "loops_found": backend.loops_found, "loop_factor_pairs": loop_pairs(backend),
        "closures_pushed_back": len(pushes), "push_back_scans": pushes,
        "ate_m": ate, "final_error_m": final,
        "launches": launches, "launches_per_scan": {k: v / n for k, v in per_scan.items()},
        "launches_keyframe_and_closure_work": per_closure,
        "launches_per_closure_attempt": {k: v / max(attempts, 1) for k, v in per_closure.items()},
        "kernel_builds_after_prewarm": served[0] - warmed[0], "kernels_loaded_after_prewarm": served[1] - warmed[1],
        "buffer_allocations_after_prewarm": served[2] - warmed[2],
        "resume_at": resume_at, "resume_bit_equal": bool(np.array_equal(again, poses[resume_at: resume_at + RESUME_SCANS])),
        "push_back_inside_resume_window": any(resume_at - 1 <= s < resume_at + RESUME_SCANS - 1 for s in pushes),
        "ab_scans": ab_scans, "ab_max_translation_m": float(ab.max()), "ab_per_scan_m": ab.tolist(),
    }
    if dev.type == "cuda":
        # B2 on the map that the push-backs re-anchored, against its plain
        # version, on the last scan's world points
        pc = scan_for_checks(torch, cfg, [seq], n - 1, sess.state.voxel_leaf, dev)
        _, bt, radius, args, query, target = nn_cases(torch, tnn, cfg, pc, sess.state, "")[1]
        ok, row = check_nn(torch, tnn, build, "nn_visits_map_reanchored", bt, radius, args, query, target)
        record["reanchored_map_check"] = row | {"ok": ok}
        record["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return record, poses


def loop_pairs(backend):
    """The (i, j) keyframe pairs of the loop factors (the sequential ones
    join k-1 and k)."""
    return [[int(i), int(j)] for i, j, _, _ in backend.factors if j != i + 1]


def live_problems(record):
    """What fails the live phase."""
    problems = []
    if not math.isfinite(record["ate_m"]) or record["ate_m"] > ATE_LIMIT_M:
        problems.append(f"live: ATE {record['ate_m']} m exceeds {ATE_LIMIT_M} m")
    if record["closures_pushed_back"] < 1:
        problems.append("live: no loop closure was pushed back")
    if record["ab_max_translation_m"] > AB_LIMIT_M:
        problems.append(f"live: kernels and plain versions differ by {record['ab_max_translation_m']} m")
    if not record["resume_bit_equal"] or record["push_back_inside_resume_window"]:
        problems.append("live: the session resumed from its checkpoint did not repeat the poses bit for bit")
    if record["kernel_builds_after_prewarm"] or record["kernels_loaded_after_prewarm"] or record["buffer_allocations_after_prewarm"]:
        problems.append("live: a kernel was built or a buffer allocated after the prewarm")
    if min(record["launches_per_scan"][k] for k in SINGLE_PATH) <= 0:
        problems.append(f"live: the served scans did not launch {SINGLE_PATH}: {record['launches_per_scan']}")
    work = record["launches_keyframe_and_closure_work"]
    if work.get("moments_visits", 0) <= 0 or work.get("nn_visits_scan", 0) <= 0:
        problems.append(f"live: the keyframe clouds (B1) or the closure GICPs (B2) launched no kernel: {work}")
    if not record.get("reanchored_map_check", {"ok": True})["ok"]:
        problems.append("live: B2 on the re-anchored map disagrees with its plain version")
    return problems


def run_slam(torch, np, cfg, seq, dev, workdir, resume_at=RESUME_AT, ab_scans=REF_SCANS):
    """runner.run_sequence(backend=) around `seq`; returns the phase record
    and the poses."""
    from locus_tpu_torch import checkpoint, pipeline, runner
    from locus_tpu_torch.backend import PoseGraphBackend
    from locus_tpu_torch.config import RegistrationConfig
    from locus_tpu_torch.ops import dispatch
    from locus_tpu_torch.ops.kernels import moments as tmom, nn as tnn

    def new_backend():
        return PoseGraphBackend(registration=RegistrationConfig(**LOOP_REGISTRATION), device=dev, **LOOP_BACKEND)

    n = len(seq)
    backend = new_backend()
    reset_launches(tnn, tmom)
    t0 = time.perf_counter()
    poses, outputs, report = runner.run_sequence(seq, cfg, backend=backend, backend_optimize_every=OPTIMIZE_EVERY,
                                                 device=dev)
    wall = time.perf_counter() - t0
    launches = read_launches(tnn, tmom)
    ate, final = trajectory_errors(np, poses, seq.gt_poses)
    dur = np.asarray(report.durations) * 1e3
    # the first resume_at scans again, checkpointed, resumed for RESUME_SCANS
    _, _, _, state = runner.run_sequence(seq, cfg, max_scans=resume_at, return_state=True, backend=new_backend(),
                                         backend_optimize_every=OPTIMIZE_EVERY, device=dev)
    path = str(workdir / "slam_ckpt.npz")
    checkpoint.save_state(path, state)
    state = checkpoint.load_state(path, pipeline.init_state(cfg, device=dev))
    again = []
    for i in range(resume_at, resume_at + RESUME_SCANS):
        state, out = runner.replay_step(state, *runner.scan_inputs(seq, i, cfg, dev), cfg=cfg)
        again.append(out.pose.cpu().numpy().astype(np.float64))
    with dispatch.no_kernels():
        plain, _, _ = runner.run_sequence(seq, cfg, max_scans=ab_scans, backend=new_backend(),
                                          backend_optimize_every=OPTIMIZE_EVERY, device=dev)
    ab = np.abs(poses[:ab_scans, :3, 3] - plain[:, :3, 3]).max(axis=1)
    return {
        "phase": "slam", "scans": n, "wall_s": wall,
        "scans_per_s": n / wall, "step_ms_p50": float(np.median(dur)), "step_ms_max": float(dur.max()),
        "keyframes": len(backend.keyframes), "loops_found": backend.loops_found,
        "loop_factor_pairs": loop_pairs(backend),
        "closures_pushed_back": backend.solves,   # run_sequence pushes back after every solve
        "ate_m": ate, "final_error_m": final,
        "launches": launches, "launches_per_scan": {k: v / n for k, v in launches.items()},
        "resume_at": resume_at, "resume_bit_equal": bool(np.array_equal(np.stack(again), poses[resume_at: resume_at + RESUME_SCANS])),
        "ab_scans": ab_scans, "ab_max_translation_m": float(ab.max()), "ab_per_scan_m": ab.tolist(),
    }, poses


def slam_problems(record):
    problems = []
    if not math.isfinite(record["ate_m"]) or record["ate_m"] > ATE_LIMIT_M:
        problems.append(f"slam: ATE {record['ate_m']} m exceeds {ATE_LIMIT_M} m")
    if record["closures_pushed_back"] < 1:
        problems.append("slam: no loop closure was pushed back")
    if record["ab_max_translation_m"] > AB_LIMIT_M:
        problems.append(f"slam: kernels and plain versions differ by {record['ab_max_translation_m']} m")
    if not record["resume_bit_equal"]:
        problems.append("slam: the replay resumed from its checkpoint did not repeat the poses bit for bit")
    if min(record["launches"][k] for k in SINGLE_PATH) <= 0:
        problems.append(f"slam: the replay did not launch {SINGLE_PATH}: {record['launches']}")
    return problems


def device_time_ms(torch, fn, reps=20, warmup=3):
    """Median device time of fn() in ms: CUDA events around each call,
    queued behind a sleep kernel so host enqueue time is not measured."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(ops, nbytes):
    t_ops = ops / PEAK_FP32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def floor_ms(torch, build, grid, threads):
    """Device time of the empty kernel with `grid` and `threads` a block."""
    return device_time_ms(torch, lambda: build.launch_empty(grid, threads, torch.cuda.current_stream().cuda_stream))


def nn_grid(torch, tnn, q, t_aug, bt):
    """The (tile parts, members, target splits) grid of a B2/B3 launch."""
    batch = q.shape[0] if q.dim() == 3 else 1
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return tnn.launch_grid(batch, q.shape[-2] // tnn.BQ, t_aug.shape[-2] // bt, bt, sms)


def nn_cases(torch, tnn, cfg, pc, state, suffix):
    """The B2 (scan, map) calls of one robot's step, or the B3 ones of a
    batch's, on the reference run's state: (name, bt, radius, (cnt, ids, q,
    t_aug), query, target) each, the query and target coordinates for the
    PyTorch yardstick. A batch adds the informational B3 map at B = 16:
    its members stacked four times."""
    from locus_tpu_torch.core.cloud import PAD_COORD

    scan_ref, mp = state.odom.reference, state.map
    q_scan = torch.where(pc.mask[..., None], pc.xyz, PAD_COORD)
    world = pc.transform(state.loc.integrated).xyz
    scan_aug = tnn.build_nn_target(scan_ref.xyz, bt=tnn.SCAN_BT)
    scan_box = tnn.chunk_boxes(scan_ref.xyz, scan_ref.mask, scan_aug.shape[-2], bt=tnn.SCAN_BT)
    cases = []
    for kind, query, t_aug, target, (c_min, c_max), radius, bt in (
        ("scan", q_scan, scan_aug, scan_ref.xyz, scan_box, cfg.odometry.corr_dist, tnn.SCAN_BT),
        ("map", world, mp.nn_aug, mp.cloud.xyz, (mp.chunk_min, mp.chunk_max), cfg.mapper.ann_search_radius, tnn.BT),
    ):
        cnt, ids = tnn.visit_lists(*tnn.tile_boxes(query), c_min, c_max, radius * radius)
        cases.append((f"nn_visits{suffix}_{kind}", bt, radius, (cnt, ids, tnn.pack_query(query), t_aug), query, target))
    if suffix:
        name, bt, radius, args, query, target = cases[-1]
        cases.append((f"{name}_b16", bt, radius, tuple(x.repeat((4,) + (1,) * (x.dim() - 1)) for x in args),
                      query.repeat(4, 1, 1), target.repeat(4, 1, 1)))
    return cases


def check_nn(torch, tnn, build, name, bt, radius, args, query, target):
    """Kernel B2 (one member) or B3 (a leading batch) against its plain
    version on one call: score bits and index on every row."""
    cnt, ids, q, t_aug = args
    batched = q.dim() == 3
    run, counts = (tnn.nn_visits_batched, tnn.batched_launches) if batched else (tnn.nn_visits, tnn.launches)
    before = dict(counts)
    ks, ki = run(*args, bt)
    torch.cuda.synchronize()
    ps, pi = tnn.nn_visits_plain(*args, bt)
    differ = ks != ps
    score_bits = int((ks.view(torch.int32) != ps.view(torch.int32)).sum())
    index_diff = int((ki != pi).sum())
    err = float((ks - ps)[differ].abs().max()) if bool(differ.any()) else 0.0
    ok = score_bits == 0 and index_diff == 0
    visited = int(cnt.sum()) * tnn.BQ * bt
    ms = device_time_ms(torch, lambda: run(*args, bt))
    counts.update(before)  # comparison launches are not main-path launches
    plain_ms = device_time_ms(torch, lambda: tnn.nn_visits_plain(*args, bt), reps=5)
    try:
        lib_ms = device_time_ms(torch, lambda: torch.cdist(query, target).min(-1), reps=5)
    except torch.cuda.OutOfMemoryError:
        lib_ms = None  # the (B, n, m) distance matrix does not fit on the card
    grid = nn_grid(torch, tnn, q, t_aug, bt)
    nbytes = (q.numel() + t_aug.numel() + cnt.numel() + ids.numel()) * 4 + q.shape[:-1].numel() * 8
    # 7 unfused operations per visited pair: 3 multiplies, 3 adds, a compare
    b, by = bound_ms(visited * 7, nbytes)
    valid = torch.all(query.abs() < 1e7, dim=-1)
    return ok, {
        "name": name, "route": "cuda", "source": "locus_tpu_torch/csrc/nn.cu",
        "replaces": "locus_tpu/ops/pallas/nn.py:256" if batched else "locus_tpu/ops/pallas/nn.py:208",
        "batch": q.shape[0] if batched else 1, "grid": list(grid),
        "queries": query.shape[-2], "targets": target.shape[-2], "bt": bt, "radius": float(radius),
        "visited_pairs": visited, "max_abs_err": err, "rows": q.shape[:-1].numel(),
        "score_bit_mismatches": score_bits, "index_mismatches": index_diff,
        "tolerance": "score bits and index equal on every row",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
        "floor_ms": floor_ms(torch, build, grid, tnn.THREADS), "valid_queries": int(valid.sum()),
    }


def compare_moments(k, p):
    """(ok, max abs error, sum mismatches, count mismatches) of kernel sums k
    against the plain version's p on every row: the two must be equal."""
    kv, pv = k.double(), p.double()
    sum_mismatches = int((kv != pv).sum())
    count_mismatches = int((kv[..., 9] != pv[..., 9]).sum())
    return sum_mismatches == 0, float((kv - pv).abs().max()), sum_mismatches, count_mismatches


MOMENT_SOURCES = {
    "moments_visits": "locus_tpu/ops/pallas/moments.py:191",
    "moments_visits_batched": "locus_tpu/ops/pallas/moments.py:222",
    "moments_dense": "locus_tpu/ops/pallas/moments.py:51",
    "moments_dense_batched": "locus_tpu/ops/pallas/moments.py:81",
}


def check_moments(torch, tmom, build, query, radius):
    """Kernel B1 (one member) or B4 (a leading batch, one radius each)
    against its plain version on one main-path call, then the dense kernel
    B5 (B6) against its plain version on the same inputs, with the counts
    in which dense and pruned differ (expected only at the f32 radius)."""
    batched = query.dim() == 3
    r2 = (radius * radius).reshape(-1).to(torch.float32)
    cnt, ids = tmom.prune(query, query, r2)
    q, t = tmom.pack_operands(query, query)
    qd, td = tmom.pack_operands(query, query, bt=tmom.DENSE_BT)
    names = ("moments_visits_batched", "moments_dense_batched") if batched else ("moments_visits", "moments_dense")
    pruned = tmom.moments_visits_batched if batched else tmom.moments_visits
    dense = tmom.moments_dense_batched if batched else tmom.moments_dense
    counters = ("batched_launches", "dense_batched_launches") if batched else ("launches", "dense_launches")
    before = {c: getattr(tmom, c) for c in counters}
    dense_visits = tmom.dense_visits(qd, td)
    runs = (
        (names[0], lambda: pruned(cnt, ids, r2, q, t), lambda: tmom.moments_visits_plain(cnt, ids, r2, q, t),
         q, t, int(cnt.sum()) * tmom.BQ * tmom.MBT),
        (names[1], lambda: dense(r2, qd, td),
         lambda: tmom.moments_visits_plain(*dense_visits, r2, qd, td, tmom.DENSE_BT),
         qd, td, qd.shape[:-1].numel() * td.shape[-2]),
    )
    oks, results, sums = [], [], []
    for name, kernel, plain, qq, tt, visited in runs:
        k = kernel()
        torch.cuda.synchronize()
        p = plain()
        ok, err, sum_mismatches, count_mismatches = compare_moments(k, p)
        sums.append(k[..., : query.shape[-2], :])
        inside = int(p[..., 9].sum())
        ms = device_time_ms(torch, kernel)
        plain_ms = device_time_ms(torch, plain, reps=5)
        nbytes = (qq.numel() + tt.numel() + r2.numel()) * 4 + qq.shape[:-1].numel() * tmom.NM * 4
        kind = "visits" if name.startswith("moments_visits") else "dense"
        bt = tmom.MBT if kind == "visits" else tmom.DENSE_BT
        grid, threads = tmom.launch_grid(kind, query.shape[0] if batched else 1, qq.shape[-2] // tmom.BQ)
        if kind == "visits":
            nbytes += (cnt.numel() + ids.numel()) * 4
        # 8 ops per visited pair (3 mul, 4 add, compare) + 16 per pair inside
        # the radius (6 products, 10 sums)
        b, by = bound_ms(visited * 8 + inside * 16, nbytes)
        oks.append(ok)
        results.append({
            "name": name, "route": "cuda", "source": "locus_tpu_torch/csrc/moments.cu",
            "replaces": MOMENT_SOURCES[name], "batch": query.shape[0] if batched else 1,
            "queries": query.shape[-2], "targets": query.shape[-2],
            "bt": bt,
            "radius": radius.reshape(-1).tolist(), "visited_pairs": visited, "pairs_in_radius": inside,
            "max_abs_err": err, "sum_mismatches": sum_mismatches, "count_mismatches": count_mismatches,
            "tolerance": "the ten sums equal on every row", "grid": list(grid), "threads": threads,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None,
            "floor_ms": floor_ms(torch, build, grid, threads),
        })
        if kind == "dense":  # each tile's targets over this many blocks, merged in the launch
            results[-1]["target_splits"] = tmom.DENSE_SPLIT[0]
    for c, v in before.items():
        setattr(tmom, c, v)  # comparison launches are not main-path launches
    # dense (B5/B6) against pruned (B1/B4) counts over the valid queries:
    # they may differ only where a neighbour lies at the radius to f32
    # rounding (the float64 distance within 1e-5 r of r)
    valid = torch.all(query.abs() < 1e7, dim=-1)
    differ = valid & (sums[0][..., 9] != sums[1][..., 9])
    X = query.double()
    r = radius.double().reshape(radius.shape + (1, 1))
    d = torch.sqrt(((X[..., :, None, :] - X[..., None, :, :]) ** 2).sum(-1))
    at_radius = (((d - r).abs() <= 1e-5 * r) & valid[..., None, :]).any(-1)
    results[1]["dense_vs_pruned_count_mismatches"] = int(differ.sum())
    results[1]["dense_vs_pruned_mismatches_off_the_radius"] = int((differ & ~at_radius).sum())
    return all(oks), results


def scan_for_checks(torch, cfg, seqs, i, leaf, dev):
    """Scan i of each sequence cropped and voxelised at `leaf`, as the step
    would feed the kernels: one cloud, or a batch of them."""
    from locus_tpu_torch import runner
    from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud
    from locus_tpu_torch.ops import filters, voxel

    args = [runner.scan_inputs(s, i, cfg, dev) for s in seqs]
    xyz = torch.stack([a[0] for a in args]).squeeze(0)
    mask = torch.stack([a[1] for a in args]).squeeze(0)
    raw = PointCloud(torch.where(mask[..., None], xyz, PAD_COORD), torch.zeros_like(xyz),
                     torch.zeros(mask.shape, device=dev), mask)
    pc = filters.crop_box(raw, cfg.filtering.box_min, cfg.filtering.box_max)
    return voxel.voxel_downsample(pc, leaf, capacity=cfg.scan_capacity, with_attributes=False)


def kernel_checks(torch, tnn, tmom, build, cfg, pc, state, suffix):
    """B1/B5 and B2 (scan, map) on one robot's inputs, or B4/B6, B3 (scan,
    map) and B3 map at B = 16 on a batch's, all from the reference run's
    state."""
    ok_m, results = check_moments(torch, tmom, build, pc.xyz, cfg.filtering.normals_radius_scale * state.voxel_leaf)
    oks = [ok_m]
    for case in nn_cases(torch, tnn, cfg, pc, state, suffix):
        ok, res = check_nn(torch, tnn, build, *case)
        oks.append(ok), results.append(res)
    return all(oks), results


def reset_launches(tnn, tmom):
    for counts in (tnn.launches, tnn.batched_launches):
        counts.update({bt: 0 for bt in counts})
    tmom.launches = tmom.batched_launches = tmom.dense_launches = tmom.dense_batched_launches = 0


def read_launches(tnn, tmom):
    return {
        "moments_visits": tmom.launches,
        "nn_visits_scan": tnn.launches[tnn.SCAN_BT],
        "nn_visits_map": tnn.launches[tnn.BT],
        "nn_visits_batched_scan": tnn.batched_launches[tnn.SCAN_BT],
        "nn_visits_batched_map": tnn.batched_launches[tnn.BT],
        "moments_visits_batched": tmom.batched_launches,
        "moments_dense": tmom.dense_launches,
        "moments_dense_batched": tmom.dense_batched_launches,
    }


def run_path(torch, np, runner, tnn, tmom, cfg, seq, ref_poses, name, dev):
    """One path's PATH_SCANS-scan replay through the kernels, launch counts
    of this run only, and its first poses against its plain reference."""
    from locus_tpu_torch.metrics import ate_rmse

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tnn, tmom)
    t0 = time.perf_counter()
    poses, outputs, report = runner.run_sequence(seq, cfg, max_scans=PATH_SCANS, device=dev)
    wall = time.perf_counter() - t0
    launches = read_launches(tnn, tmom)
    dur = np.asarray(report.durations)
    window = dur[-RATE_WINDOW:]
    ate = ate_rmse(poses[:, :3, 3], seq.gt_poses[: poses.shape[0], :3, 3], align=False)
    ab = np.abs(poses[:REF_SCANS, :3, 3] - ref_poses[:, :3, 3]).max(axis=1)
    return {
        "phase": name, "scans": int(poses.shape[0]),
        "sequence": PATH_SEQUENCE_NAMES.get(name, "make_tunnel_sequence(azimuth_steps=1800, step=0.35, seed=0)"),
        "scans_per_s_last32": window.size / float(window.sum()),
        "ms_per_scan_p50_last32": float(np.median(window) * 1e3),
        "ms_per_scan_max_last32": float(window.max() * 1e3),
        "first_scan_s": float(dur[0]), "wall_s": wall, "ate_m": ate,
        "ab_scans": REF_SCANS, "ab_max_translation_m": float(ab.max()), "ab_per_scan_m": ab.tolist(),
        "ab_max_rotation_entry": float(np.abs(poses[:REF_SCANS, :3, :3] - ref_poses[:, :3, :3]).max()),
        "launches": launches, "launches_per_scan": {k: v / poses.shape[0] for k, v in launches.items()},
        "keyframes": int(sum(o["keyframe_inserted"] for o in outputs)),
        "final_map_size": outputs[-1]["map_size"], "mean_points": float(np.mean([o["num_points"] for o in outputs])),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card and has no CPU path", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import locus_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the locus_tpu_torch package is not beside this script: {e}", file=sys.stderr)
        return 2
    if Path(locus_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print("chip_smoke: locus_tpu_torch was imported from outside this checkout", file=sys.stderr)
        return 2
    if "jax" in sys.modules or "locus_tpu" in sys.modules:
        print("chip_smoke: JAX or locus_tpu got imported", file=sys.stderr)
        return 2

    import numpy as np

    from locus_tpu_torch import config as cfg_mod, pipeline, runner
    from locus_tpu_torch.io import dataset
    from locus_tpu_torch.io.dataset import make_tunnel_sequence
    from locus_tpu_torch.metrics import RateReport, ate_rmse
    from locus_tpu_torch.ops import dispatch
    from locus_tpu_torch.ops.kernels import build, moments as tmom, nn as tnn

    record = {}
    dev = torch.device("cuda")
    try:
        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        record["device"] = {
            "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi_line,
            "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
        }
        emit(record["device"])

        # 2. build
        t0 = time.perf_counter()
        secs = build.build(build.KERNELS + (build.FLOOR,))
        record["build"] = {
            "phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": secs,
            "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln or "smem" in ln] for k, v in build.build_logs.items()},
        }
        emit(record["build"])

        cfg = production_config(cfg_mod)
        t0 = time.perf_counter()
        seq = make_tunnel_sequence(num_scans=SCANS, azimuth_steps=1800, step=0.35, seed=0)
        robot_seqs = [
            make_tunnel_sequence(num_scans=ROBOT_SCANS, azimuth_steps=1800, step=st, seed=b)
            for b, st in enumerate(ROBOT_STEPS)
        ]
        data_s = time.perf_counter() - t0

        # 3. reference: the plain versions on the card
        t0 = time.perf_counter()
        with dispatch.no_kernels():
            ref_poses, _, _, ref_state = runner.run_sequence(
                seq, cfg, max_scans=REF_SCANS, return_state=True, device=dev
            )
        single_s = time.perf_counter() - t0
        robot_packed = [runner.pack_sequence(s, cfg, device=dev) for s in robot_seqs]
        first_ticks = runner.stack_packed([{k: v[:REF_SCANS] for k, v in p.items()} for p in robot_packed])
        init_poses = np.stack([s.gt_poses[0] for s in robot_seqs])
        t0 = time.perf_counter()
        ref_states, _ = runner.make_batched_replay(cfg, use_pallas=False)(
            pipeline.init_states(cfg, init_poses, device=dev), first_ticks
        )
        batched_s = time.perf_counter() - t0
        path_refs, path_seqs, path_s = {}, {}, {}
        for name in PATHS:
            t0 = time.perf_counter()
            path_seqs[name] = path_sequence(dataset, name, seq)
            with dispatch.no_kernels():
                path_refs[name] = runner.run_sequence(
                    path_seqs[name], path_config(cfg, name), max_scans=REF_SCANS, return_state=True, device=dev
                )
            path_s[name] = time.perf_counter() - t0
        record["reference"] = {
            "phase": "reference", "scans": REF_SCANS, "seconds": single_s, "data_seconds": data_s,
            "batched_ticks": REF_SCANS, "batched_seconds": batched_s, "path_seconds": path_s,
        }
        emit(record["reference"])

        # 4. kernels at the main paths' shapes, inputs from the reference states
        pc = scan_for_checks(torch, cfg, [seq], REF_SCANS, ref_state.voxel_leaf, dev)
        ok_single, results = kernel_checks(torch, tnn, tmom, build, cfg, pc, ref_state, "")
        pcb = scan_for_checks(torch, cfg, robot_seqs, REF_SCANS, ref_states.voxel_leaf, dev)
        ok_batched, batched_results = kernel_checks(torch, tnn, tmom, build, cfg, pcb, ref_states, "_batched")
        results += batched_results
        # B2 map on the voxel-hash operand: a slot is a hash of its voxel,
        # so every chunk spans the window and a tile visits every chunk
        vh_cfg, vh_state = path_config(cfg, "voxel_hash"), path_refs["voxel_hash"][3]
        pcv = scan_for_checks(torch, cfg, [seq], REF_SCANS, vh_state.voxel_leaf, dev)
        _, bt, radius, args, query, target = nn_cases(torch, tnn, vh_cfg, pcv, vh_state, "")[1]
        ok_vh, res_vh = check_nn(torch, tnn, build, VOXEL_HASH_MAP, bt, radius, args, query, target)
        results.append(res_vh)
        record["kernels"] = {
            "phase": "kernels", "checks": results, "map_points": int(ref_state.map.cloud.mask.sum()),
            "voxel_hash_map_points": int(vh_state.map.cloud.mask.sum()),
            "batched_map_points": ref_states.map.cloud.mask.sum(-1).tolist(),
            "batched_leaves": ref_states.voxel_leaf.tolist(),
        }
        emit(record["kernels"])
        if not (ok_single and ok_batched and ok_vh):
            raise RuntimeError("a kernel disagrees with its plain version")

        # 5. pipeline through the kernels, launch counts of this run only
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(tnn, tmom)
        t0 = time.perf_counter()
        poses, outputs, report = runner.run_sequence(seq, cfg, device=dev)
        wall = time.perf_counter() - t0
        launches = read_launches(tnn, tmom)
        dur = np.asarray(report.durations)
        gt = seq.gt_poses[: poses.shape[0]]
        ate = ate_rmse(poses[:, :3, 3], gt[:, :3, 3], align=False)
        record["pipeline"] = {
            "phase": "pipeline", "scans": int(poses.shape[0]),
            "scans_per_s_last32": RATE_WINDOW / float(dur[-RATE_WINDOW:].sum()),
            "ms_per_scan_p50_last32": float(np.median(dur[-RATE_WINDOW:]) * 1e3),
            "ms_per_scan_max_last32": float(dur[-RATE_WINDOW:].max() * 1e3),
            "first_scan_s": float(dur[0]), "wall_s": wall, "ate_m": ate,
            "launches": launches, "launches_per_scan": {k: v / poses.shape[0] for k, v in launches.items()},
            "keyframes": int(sum(o["keyframe_inserted"] for o in outputs)),
            "final_map_size": outputs[-1]["map_size"], "mean_points": float(np.mean([o["num_points"] for o in outputs])),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        emit(record["pipeline"])
        if min(launches[k] for k in SINGLE_PATH) <= 0:
            raise RuntimeError(f"the pipeline did not launch every kernel: {launches}")
        if not np.isfinite(poses).all() or ate > ATE_LIMIT_M:
            raise RuntimeError(f"ATE {ate} m exceeds {ATE_LIMIT_M} m")

        # 6. A/B against the plain versions
        ab = np.abs(poses[:REF_SCANS, :3, 3] - ref_poses[:, :3, 3]).max(axis=1)
        # rotation entries differ by about the angle between the two
        rot = float(np.abs(poses[:REF_SCANS, :3, :3] - ref_poses[:, :3, :3]).max())
        record["ab"] = {"phase": "ab", "scans": REF_SCANS, "max_translation_m": float(ab.max()),
                        "max_rotation_entry": rot, "per_scan_m": ab.tolist()}
        emit(record["ab"])
        if ab.max() > AB_LIMIT_M:
            raise RuntimeError(f"A/B: kernels and plain versions differ by {ab.max()} m")

        # 7. batched: 4 robots through make_batched_replay, each also alone
        single_replay = runner.make_scan_replay(cfg)
        single_poses = []
        for s, p in zip(robot_seqs, robot_packed):
            st = pipeline.init_state(cfg, initial_pose=torch.as_tensor(s.gt_poses[0], dtype=torch.float32), device=dev)
            single_poses.append(single_replay(st, p)[1][0].cpu().numpy().astype(np.float64))
        packed = runner.stack_packed(robot_packed)
        states = pipeline.init_states(cfg, init_poses, device=dev)
        ticks = RateReport()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(tnn, tmom)
        t0 = time.perf_counter()
        states, (bposes, _, bsizes) = runner.make_batched_replay(cfg)(states, packed, report=ticks)
        wall = time.perf_counter() - t0
        blaunches = read_launches(tnn, tmom)
        bposes = bposes.cpu().numpy().astype(np.float64)          # (T, B, 4, 4)
        dur = np.asarray(ticks.durations)
        ates = [ate_rmse(bposes[:, b, :3, 3], s.gt_poses[:ROBOT_SCANS, :3, 3], align=False)
                for b, s in enumerate(robot_seqs)]
        vs_single = [float(np.abs(bposes[:, b, :3, 3] - single_poses[b][:, :3, 3]).max()) for b in range(ROBOTS)]
        tick_rate = TICK_WINDOW / float(dur[-TICK_WINDOW:].sum())
        record["batched"] = {
            "phase": "batched", "robots": ROBOTS, "ticks": int(dur.size), "steps": list(ROBOT_STEPS),
            "ticks_per_s_last16": tick_rate, "robot_scans_per_s_last16": ROBOTS * tick_rate,
            "ms_per_tick_p50_last16": float(np.median(dur[-TICK_WINDOW:]) * 1e3),
            "ms_per_tick_max_last16": float(dur[-TICK_WINDOW:].max() * 1e3),
            "first_tick_s": float(dur[0]), "wall_s": wall,
            "ate_m": ates, "max_translation_vs_single_m": vs_single,
            "launches": blaunches, "launches_per_tick": {k: v / dur.size for k, v in blaunches.items()},
            "final_map_sizes": bsizes[-1].tolist(), "final_leaves": states.voxel_leaf.tolist(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        emit(record["batched"])
        if not np.isfinite(bposes).all() or max(ates) > ATE_LIMIT_M:
            raise RuntimeError(f"batched ATE {ates} m exceeds {ATE_LIMIT_M} m")
        if max(vs_single) > BATCHED_LIMIT_M:
            raise RuntimeError(f"batched robots differ from their single replays by {vs_single} m")
        per_tick = (blaunches["moments_visits_batched"], blaunches["nn_visits_batched_map"])
        if per_tick != (dur.size, dur.size) or blaunches["nn_visits_batched_scan"] < dur.size:
            raise RuntimeError(f"batched launches per tick are not B4 = B3-at-BT = 1: {blaunches}")
        if any(blaunches[k] for k in SINGLE_PATH):
            raise RuntimeError(f"the batched replay launched a single-member kernel: {blaunches}")

        # 8. the other single-card paths through the kernels; every path
        # runs, then any path's failure fails the script
        problems = []
        for name, expected in PATHS.items():
            record[name] = run_path(torch, np, runner, tnn, tmom, path_config(cfg, name), path_seqs[name],
                                    path_refs[name][0], name, dev)
            emit(record[name])
            launches, ate = record[name]["launches"], record[name]["ate_m"]
            if min(launches[k] for k in expected) <= 0:
                problems.append(f"{name}: the path did not launch {expected}: {launches}")
            if name == "features" and launches["moments_visits"]:
                problems.append(f"features: kernel B1 launched on the kNN-normals path: {launches}")
            if any(launches[k] for k in BATCHED_PATH):
                problems.append(f"{name}: a batched kernel launched on a single path: {launches}")
            if not np.isfinite(ate) or ate > ATE_LIMIT_M:
                problems.append(f"{name}: ATE {ate} m exceeds {ATE_LIMIT_M} m")
            if record[name]["ab_max_translation_m"] > AB_LIMIT_M:
                problems.append(f"{name}: kernels and plain versions differ by {record[name]['ab_max_translation_m']} m")
        if problems:
            raise RuntimeError("; ".join(problems))

        # 9-10. live serving and the SLAM replay around the circuit; both
        # run, then either's failure fails the script
        scfg = serving_config(cfg)
        workdir = ROOT / "chiprun_out" / "chip_smoke_work"
        workdir.mkdir(parents=True, exist_ok=True)
        for name, azimuth, run in (("live", LIVE_AZIMUTH, serve_live), ("slam", SLAM_AZIMUTH, run_slam)):
            t0 = time.perf_counter()
            circuit = circuit_sequence(CIRCUIT_SCANS, azimuth)
            data_s = time.perf_counter() - t0
            record[name] = run(torch, np, scfg, circuit, dev, workdir)[0] | {
                "azimuth_steps": azimuth, "step_m": CIRCUIT_STEP, "laps": CIRCUIT_LAPS, "seed": CIRCUIT_SEED,
                "backend": LOOP_BACKEND | LOOP_REGISTRATION, "data_seconds": data_s,
            }
            emit(record[name])
        problems = live_problems(record["live"]) + slam_problems(record["slam"])
        if problems:
            raise RuntimeError("; ".join(problems))
    except Exception:
        traceback.print_exc()
        emit({"phase": "failed", "completed": list(record)})
        return 1

    # B1/B2 summed over the single paths, live serving and the SLAM replay
    # (the ring-map B2 rows over the paths with a ring map, the voxel-hash
    # row over its own), B3/B4 from
    # the batched replay; B5/B6 and B3 at B = 16 lie on no path
    single = ("pipeline",) + tuple(PATHS) + ("live", "slam")
    counts = {k: sum(record[p]["launches"][k] for p in single) for k in SINGLE_PATH}
    counts["nn_visits_map"] -= record["voxel_hash"]["launches"]["nn_visits_map"]
    counts[VOXEL_HASH_MAP] = record["voxel_hash"]["launches"]["nn_visits_map"]
    counts |= {k: record["batched"]["launches"][k] for k in BATCHED_PATH}
    summary = [
        {k: v for k, v in r.items() if k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "floor_ms")}
        | {"launches": counts.get(r["name"], 0)}
        for r in record["kernels"]["checks"]
    ]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    emit({"kernels": summary})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
