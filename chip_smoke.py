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
               first 8 ticks of the 4-robot batched replay, the first 8
               scans of each path of phase 8 and the first 8 ticks of each
               batched path of phase 12, with the kernels' plain PyTorch
               versions (`no_kernels()`), on the card
 4. kernels    each kernel at the shapes the main paths give it (inputs
               from the reference runs' states; B5 on B1's inputs, B6 on
               B4's; B7 on the step's two GICP calls, scan-to-scan and
               scan-to-submap, one trip and the whole registration bit
               for bit; B8 on the step's own float64 Ap after the
               scan-to-submap registration), against its plain version on
               the same inputs, timed
               with CUDA events beside the plain version, a one-call
               PyTorch yardstick where one exists, and the bound from this
               run's visited pairs and the launch floor of the grid and
               block the wrapper launches (an empty kernel; B5/B6 also
               report their target splits); every kernel
               is held to the plain version's results on every row (B2/B3
               score bits and index, B1/B4-B6 the ten sums). B2 map also
               runs on the voxel-hash operand (from the voxel_hash path's
               reference state), and B3 map on the 4 robots' voxel-hash
               operands (from the batched_voxel_hash reference state,
               every chunk visited). One informational row, B3 map at B = 16
               (the four robots' inputs stacked four times), lies on no path
 5. pipeline   the 48-scan production replay through runner.run_sequence
               with launch counts reset just before and read just after;
               scans/s over the last 32 scans and ATE against ground truth
 6. ab         the pipeline's first 8 poses against the reference run's
 6b. compiled  phase 5's replay runs the captured step (one CUDA graph a
               scan: runner.make_replay_step, the GICP trips gated on the
               device); this phase replays the same 48 scans through the
               eager runner.replay_step in the same call and holds the
               two to equal poses (0.0 m), equal ATE and equal launches of
               B1 and B2; for each it prints scans/s over the last 32, and
               from a trace of the last 8 scans from the same state the
               device's busy ms and idle share, the kernels on the device,
               the launches and graph launches from the host and the host
               syncs a scan
 7. batched    4 robots, 24 scans each, through runner.make_batched_replay
               (one batched step per tick, captured: one CUDA graph a
               tick) with launch counts reset just before and read just
               after; every robot also through runner.make_scan_replay;
               ticks/s and robot-scans/s over the last 16 ticks, per-robot
               ATE and difference from the single replay (0.0 m), launches
               per tick; the same ticks through the eager batched step in
               this call (poses equal), and from a trace of the last 7
               ticks of the captured step the graph launches, kernel
               launches and syncs of the host a tick (1, 0, 0)
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
11. husky      the Husky profile (configs/husky.yaml) with its three
               lidars (configs/husky_sensors.yaml) on the production
               tunnel (`run_husky`): each lidar ray-cast at 680 azimuth
               steps, written with io.rosbag.BagWriter, one lidar silent
               for scans 16-23; the bag read back and grouped by
               sync.ApproximateTimeSync up front, then per scan the
               merger's heartbeats and health, merger.merge and one step,
               timed: scans/s over the last 32 scans, p50 and max latency,
               ATE, the lidars' health per scan, merged points, launches by
               kernel, the first 8 poses against a plain-version run, and
               B1 and B2 at this path's inputs against their plain
               versions (rows `*_husky`)
12. batched_ndt, batched_features, batched_voxel_hash
               4 robots of each path of phase 8 (`path_config`), robot b
               on its own sequence of the path's world (`robot_sequences`:
               the production tunnel at step 0.30 + 0.05b, seed b; NDT on
               its world tunnel at its source's 0.35 m, seed b),
               ROBOT_SCANS ticks of one batched step each through
               runner.make_batched_replay with launch counts reset just
               before and read just after; every
               robot also through runner.make_scan_replay: ticks/s and
               robot-scans/s over the last 16 ticks, p50 and max tick
               latency beside the single replays' scan time, per-robot
               ATE and difference from its single replay, the first 8
               ticks against the phase-3 plain reference, launches per
               tick by kernel; B3 must launch on every path, B4 on ndt and
               voxel_hash and not on features, no single-member kernel
               anywhere
13. sharded    the production replay of phase 5 with its map split over 2
               ranks (tools/torch_dist_smoke.py processes on this card, a
               (1, 2) mesh, collectives through gloo: NCCL takes one rank
               a device) through runner.make_scan_replay(mesh=), each
               rank's launch counts reset just before and read just after:
               poses against phase 5's (within 1e-4 m; the gap reported,
               0.0 expected), map sizes equal on every scan, scans/s over
               the last 32 scans and launches per scan on each rank (B2
               map on every rank's 65536-slot shard); then killed after
               24 scans (each rank saves its shards and exits), resumed
               by fresh ranks for the other 24, bit for bit the
               uninterrupted run, with the gathers' ms a scan traced
14. sharded_batched
               phase 7's 4 robots through runner.make_batched_replay(mesh=)
               on 4 ranks, a (2, 2) mesh: each data row loads and packs only
               its own 2 robots, each robot's map split over the row's 2
               ranks; each robot against its phase-7 single replay (within
               1e-4 m), B3 and B4 on every rank
15. sharded_live
               phase 9's circuit served by live.LiveSession(mesh=) on 2
               ranks, the pose-graph backend on each closing loops with
               optimize(mesh=) and pushing them back through each shard's
               re-anchor: poses up to the first push-back against phase
               9's (within 1e-4 m), ATE (0.05 m), closures, p50 and max
               latency
16. tools      the port's command-line tools as a user runs them, each in a
               process of its own with a deadline (`run_tools`, the list in
               `tool_commands`), each one's JSON echoed on a line: the
               production benchmark (tools/torch_bench.py, ATE within
               0.05 m), the eval suite's four worlds (each within 0.05 m,
               the loop world closing a loop), serving latency, the
               profiler, the sensor-drop copy, the memory report, the map
               ANN's chunk sweep with its visit statistics (ring store at
               bt 512/1024/2048, the voxel-hash operand, 2 shards; every
               timed B2 launch bit-equal to its plain version), scaling of
               the batched replay over 1/2/4 ranks on this card (poses equal
               to the 1-rank run) and the collective budget of the sharded
               replay (computed bytes equal to counted bytes); each tool but
               the sensor-drop copy (numpy only) names the card and its
               power limit, and launched its path's kernels in its main run
               (`TOOL_KERNELS`: each tool sets its counters to 0 just before
               that run and reports them just after; the phase's record
               keeps them by tool); then the five replay-level experiments
               (tools/torch_exp_*.py) at shortened windows (`EXPERIMENTS`:
               every JAX variant has its row, every variant's timed replay
               launched B1 and B2 and repeated its untimed replay's poses
               bit for bit (the tool exits non-zero otherwise), exp_gap's
               default poses within 1e-4 m of
               phase 5's, exp_inner's inner-3 worlds within 0.05 m ATE)
               and examples/torch_quickstart.py at QUICKSTART_SCANS scans
Every phase's line says whether its replays ran the captured step
(`captured`; the batched, live, husky, NDT, features, voxel-hash and
sharded runs step eagerly, later slices of the capture).
A launch of ranks that outlasts its deadline is ended and fails its phase.
Then the `kernels` summary line (launches summed over every path, the
batched paths' on the B3/B4 rows (B3 map on the voxel-hash operand on
its own row); the `_husky` rows carry the husky phase's, the `_shard`
rows the B2/B3 map launches of the sharded phases; phases 1-15 only: the
tools' runs hold warm-ups and timing loops, so their launches stay in
phase 16's record), the nvidia-smi line, and the final `{"ok": true,
...}` line. The full record also goes to chiprun_out/chip_smoke.json.
"""
import functools
import json
import math
import shutil
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
COMPILED_TRACE = 8   # scans of each replay the compiled phase traces
COMPILED_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
COMPILED_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
ROBOTS, ROBOT_SCANS, TICK_WINDOW = 4, 24, 16
ROBOT_STEPS = (0.30, 0.35, 0.40, 0.45)
ATE_LIMIT_M = 0.05
AB_LIMIT_M = 1e-3
BATCHED_LIMIT_M = 1e-3  # each robot of the batched replay against its single replay
# the kernels each replay launches: B1, B2 (scan, map); B4, B3 (scan, map)
SINGLE_PATH = ("moments_visits", "nn_visits_scan", "nn_visits_map")
BATCHED_PATH = ("moments_visits_batched", "nn_visits_batched_scan", "nn_visits_batched_map")
# B7's launches (a GICP trip, single or batched) and the CUDA trips that
# ran its plain version (covariances other than the normals' disks)
GICP_ROWS = ("gicp_trip", "gicp_plain_trips")
# B8's launches (the covariance's 6x6 eigendecomposition, single or batched)
EIGH_ROWS = ("eigh6",)
# B7's timed trips: convergence never reached, so each does a whole trip
GICP_NEVER = {"tf_epsilon": 1e-30, "rotation_epsilon": 1e-30, "final_correspondence_relookup": False}
# the other single-card paths (phase 8) and the kernels each must launch:
# B2 always, B1 except on features (kNN normals, no radius moments)
PATHS = {
    "ndt": SINGLE_PATH,
    "features": ("nn_visits_scan", "nn_visits_map"),
    "voxel_hash": SINGLE_PATH,
}
PATH_SCANS = 48
VOXEL_HASH_MAP = "nn_visits_map_voxel_hash"   # the B2 map row on the voxel-hash operand
BATCHED_VOXEL_HASH_MAP = "nn_visits_batched_map_voxel_hash"   # B3 map on the robots' voxel-hash operands
# the batched paths (phase 12) and the kernels each must launch: B3 (scan
# and map) always, B4 except on features (kNN normals)
BATCHED_PATHS = {
    "ndt": BATCHED_PATH,
    "features": ("nn_visits_batched_scan", "nn_visits_batched_map"),
    "voxel_hash": BATCHED_PATH,
}
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
# The husky phase: the Husky profile (configs/husky.yaml) with its three
# VLP-16s at the extrinsics of configs/husky_sensors.yaml, on the
# production tunnel's world, trajectory and wheel odometry. Each lidar is
# ray-cast at HUSKY_AZIMUTH steps: 3 x 16 x 680 = 32640 points fit the
# profile's 32768-point merged budget (a VLP-16's 1800 steps would not),
# the one cut. Stamps jitter by up to HUSKY_JITTER_S; the bag's tuples are
# grouped within HUSKY_SLOP_S; lidar HUSKY_DEAD_LIDAR sends nothing during
# HUSKY_DEAD_SCANS. A lidar silent for LIDAR_TIMEOUT_S (1.5 sweep periods,
# the timeout of tests/test_multilidar.py) is neither awaited by the
# synchronizer nor merged.
HUSKY_SCANS, HUSKY_AZIMUTH, HUSKY_STEP = 48, 680, 0.35
HUSKY_T0, HUSKY_JITTER_S, HUSKY_SLOP_S, LIDAR_TIMEOUT_S = 100.0, 0.01, 0.05, 0.15
HUSKY_DEAD_LIDAR, HUSKY_DEAD_SCANS, HUSKY_ALIVE_BY = 1, (16, 23), 26
HUSKY_ODOM_TOPIC = "/husky_velocity_controller/odom"
HUSKY_SUFFIX = "_husky"    # the kernels' rows at the husky path's inputs
# The sharded phases (13-15): tools/torch_dist_smoke.py as ranks on this
# one card, their collectives through gloo. sharded: phase 5's replay with
# the map over SHARDED_RANKS ranks, killed after SHARDED_RESUME_AT scans
# and resumed; sharded_batched: phase 7's robots on a (2, 2) mesh;
# sharded_live: phase 9's circuit served on SHARDED_RANKS ranks.
SHARDED_RANKS, SHARDED_BATCHED_RANKS, SHARDED_RESUME_AT = 2, 4, 24
RANK_TIMEOUT_S = 420          # a launch of ranks is ended after this
SHARDED_LIMIT_M = 1e-4        # sharded against single (JAX's bound; 0.0 expected)
SHARD_SUFFIX = "_shard"       # the B2/B3 map rows at one shard's operand
RANK_INPUTS = "rank_inputs"   # the ranks' sequences, references and checkpoints, deleted after the phases
# Phase 16: the tools (tools/torch_*.py), each a process with a deadline.
TOOL_TIMEOUT_S = 600
EVAL_SCANS = 60               # tools/eval_suite.py's 60 scans a world
LATENCY_SCANS = 32            # of tools/latency_bench.py's 64
COLLECTIVE_SCANS = 12         # of tools/torch_collective_budget.py's 24 (the bytes do not depend on it)
NN_BENCH_BTS = (512, 1024, 2048)   # the map ANN sweep's chunk sizes (tools/torch_nn_bench.py)
# The replay-level experiments (tools/torch_exp_*.py) at shortened windows
# (12-18 timed scans, one rep, every variant), with the names of the JAX
# tools' variants (tools/exp_*.py), each of which must have its row; and
# the quickstart at a few scans.
EXPERIMENTS = {
    "exp_ablate": ("torch_exp_ablate.py", ["--scans", 18, "--reps", 1],
                   ("base", "no_kf_msw", "no_cov", "s2s_0iter", "s2m_0iter", "no_adapt")),
    "exp_gap": ("torch_exp_gap.py", ["--scans", 12, "--reps", 1],
                ("default", "no_keyframes", "iter_cap_8", "iter_cap_4", "inner_2", "no_cov", "no_adaptive")),
    "exp_gap2": ("torch_exp_gap2.py", ["--scans", 24, "--reps", 1],
                 ("warm_default", "warm_no_kf", "warm_no_msw_gate", "warm_no_cov", "warm_inner2",
                  "warm_no_adaptive_leaf", "warm_fusion_none", "warm_no_seq_stats", "warm_no_sensor_push")),
    # windows of 9 and 27 scans after a 3-scan warm-up (48, 144, 16 at full size)
    "exp_steady": ("torch_exp_steady.py", ["--scans", 27, "--reps", 1], ("fresh9", "steady6", "fresh27", "steady24")),
    "exp_inner": ("torch_exp_inner.py", ["--scans", 12, "--world-scans", 12, "--reps", 1], ("inner3", "inner2")),
}
QUICKSTART_SCANS = 6
EXP_POSE_LIMIT_M = 1e-4       # exp_gap's default variant against phase 5 (the same step; 0.0 expected)
# the kernels each tool's main run must launch (each process or rank): B2
# at every swept chunk size on the sweep (bt 1024 has a counter of its own)
TOOL_KERNELS = {
    "bench": SINGLE_PATH, "eval_suite": SINGLE_PATH, "latency_bench": SINGLE_PATH, "profiler": SINGLE_PATH,
    "memory_report": SINGLE_PATH, "nn_bench": ("nn_visits_scan", "nn_visits_bt1024", "nn_visits_map"),
    "nn_bench_voxel_hash": ("nn_visits_map",), "nn_bench_shards": ("nn_visits_map",),
    "scaling_bench": BATCHED_PATH, "collective_budget": SINGLE_PATH,
} | {name: SINGLE_PATH for name in EXPERIMENTS}
DROP_GAPS = (("--odom-gaps", "0.5:0.9"), ("--imu-gaps", "1.0:1.2"))


START = time.perf_counter()


def emit(record: dict) -> None:
    """Print `record` as one JSON line, with the seconds since the script
    started (`t_s`, for the phases' share of the time limit)."""
    print(json.dumps(record | {"t_s": time.perf_counter() - START}), flush=True)


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


def robot_sequences(dataset, name, num_scans=ROBOT_SCANS, robots=ROBOTS):
    """Robot b's sequence on a path, on the path's world (`path_sequence`):
    phase 7's scheme, step 0.30 + 0.05b and seed b, on the production
    tunnel; NDT on its world tunnel at 900 azimuth steps, every robot at
    its source's step (EVAL_NDT_r05.json: 21 m in 60 scans, 0.35 m) with
    seed b. NDT at 1.0 m voxels drifts past the 0.05 m ATE gate at 0.45 m
    a scan (0.067 m on the card; the JAX package's NDT drifts as far on
    that trajectory, PERF.md), outside the regime its source measured."""
    if name == "ndt":
        return [dataset.make_world_sequence("tunnel", num_scans=num_scans, azimuth_steps=900, step=0.35, seed=b)
                for b in range(robots)]
    return [dataset.make_tunnel_sequence(num_scans=num_scans, azimuth_steps=1800, step=round(0.30 + 0.05 * b, 2),
                                         seed=b) for b in range(robots)]


ROBOT_SEQUENCE_NAMES = {
    "ndt": 'make_world_sequence("tunnel", azimuth_steps=900, step=0.35, seed=b)',
    "features": "make_tunnel_sequence(azimuth_steps=1800, step=0.30+0.05b, seed=b)",
    "voxel_hash": "make_tunnel_sequence(azimuth_steps=1800, step=0.30+0.05b, seed=b)",
}


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


def launch_delta(before):
    from locus_tpu_torch.ops.kernels import read_launches

    return {k: v - before[k] for k, v in read_launches().items()}


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
    from locus_tpu_torch.ops.kernels import build, nn as tnn, read_launches, reset_launches

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
    reset_launches()
    t_run = time.perf_counter()
    for i in range(n):
        before = read_launches()
        t0 = time.perf_counter()
        pose, out = serve(sess, i)
        lat.append(time.perf_counter() - t0)
        add_counts(per_scan, launch_delta(before))
        poses.append(np.asarray(pose, np.float64))
        if i + 1 == resume_at:
            shutil.copy(ckpt, workdir / "live_resume.npz")
        if out.keyframe_inserted:
            before = read_launches()
            backend.add_keyframe(float(seq.stamps[i]), pose, cloud=verification(i))
            keyframes += 1
            if keyframes % OPTIMIZE_EVERY == 0:
                attempts += 1
                if backend.try_close_loops() > 0:
                    backend.optimize()
                    sess.apply_loop_closure(backend.correction_for_latest(), backend.last_corrections)
                    pushes.append(i)
            add_counts(per_closure, launch_delta(before))
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
        "phase": "live", "scans": n, "wall_s": wall, "captured": False,   # LiveSession steps eagerly
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
    from locus_tpu_torch.ops.kernels import read_launches, reset_launches

    def new_backend():
        return PoseGraphBackend(registration=RegistrationConfig(**LOOP_REGISTRATION), device=dev, **LOOP_BACKEND)

    n = len(seq)
    backend = new_backend()
    reset_launches()
    t0 = time.perf_counter()
    poses, outputs, report = runner.run_sequence(seq, cfg, backend=backend, backend_optimize_every=OPTIMIZE_EVERY,
                                                 device=dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
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
        "phase": "slam", "scans": n, "wall_s": wall, "captured": report.captured,
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


def husky_extrinsics():
    """The Husky's lidar -> base transforms (configs/husky_sensors.yaml),
    by name, in the file's order."""
    from locus_tpu_torch.io import sensors

    return sensors.load_sensor_extrinsics(str(ROOT / "configs" / "husky_sensors.yaml"))[0]


def write_husky_bag(np, path, lidars, num_scans=HUSKY_SCANS, azimuth=HUSKY_AZIMUTH, dead_scans=HUSKY_DEAD_SCANS,
                    workers=6, seed=0):
    """Ray-cast each lidar of `lidars` along make_tunnel_sequence(num_scans,
    step=HUSKY_STEP, seed=seed)'s trajectory through its world and write
    the sweeps (stamps jittered per lidar) and the wheel odometry to a bag
    with the port's BagWriter, in stamp order; lidar HUSKY_DEAD_LIDAR sends
    nothing during `dead_scans` (first, last). Returns the ground truth."""
    from concurrent.futures import ThreadPoolExecutor

    from locus_tpu_torch.io import dataset, rosbag, synthetic

    world = synthetic.BoxWorld.default_tunnel(length=num_scans * HUSKY_STEP + 30.0)
    gt = synthetic.make_trajectory(num_scans, step=HUSKY_STEP, seed=seed)
    # the odometry stream of make_tunnel_sequence (the same draws)
    seq = dataset._with_simulated_sensors(dataset.Sequence(
        scans=np.zeros((num_scans, 1, 3), np.float32), scan_valid=np.zeros((num_scans, 1), bool),
        stamps=np.arange(num_scans) / 10.0, gt_poses=gt), rate_hz=10.0, seed=seed)
    names = list(lidars)
    jitter = np.random.default_rng(seed + 1).uniform(0.0, HUSKY_JITTER_S, size=(num_scans, len(names)))

    def sweep(job):
        i, k = job
        pts, valid = synthetic.simulate_scan(world, gt[i] @ lidars[names[k]].astype(np.float64),
                                             azimuth_steps=azimuth, noise=0.005, seed=seed + 3 * i + k)
        stamp = HUSKY_T0 + seq.stamps[i] + jitter[i, k]
        return stamp, f"/{names[k]}/velodyne_points", "sensor_msgs/PointCloud2", \
            rosbag.serialize_pointcloud2(stamp, names[k], pts[valid])

    jobs = [(i, k) for i in range(num_scans) for k in range(len(names))
            if not (k == HUSKY_DEAD_LIDAR and dead_scans[0] <= i <= dead_scans[1])]
    with ThreadPoolExecutor(workers) as pool:
        msgs = list(pool.map(sweep, jobs))
    for t, pose in zip(HUSKY_T0 + seq.odom_stamps, seq.odom_poses):
        msgs.append((t, HUSKY_ODOM_TOPIC, "nav_msgs/Odometry", rosbag.serialize_odometry(t, "odom", "base_link", pose)))
    writer = rosbag.BagWriter(str(path))
    try:
        for stamp, topic, msg_type, raw in sorted(msgs, key=lambda m: m[0]):
            writer.write(topic, msg_type, stamp, raw)
    finally:
        writer.close()
    return gt


def read_husky_bag(np, path, names, gt):
    """Parse the bag up front, as a replay would: every lidar message is a
    heartbeat of its lidar and goes to the approximate-time synchronizer,
    which emits one tuple a sweep. Returns (scans, seq): per merged scan a
    dict of the heartbeats heard since the previous tuple ((lidar, stamp)),
    the stamp of the message that completed the tuple ("now", when the
    lidars' health is read) and the tuple's clouds {lidar: (N,3) f32}; seq,
    a port Sequence without points holding the tuples' stamps (their
    earliest message) and the odometry stream, both less the first tuple's
    stamp, and the ground truth of each tuple's sweep."""
    from locus_tpu_torch.io import dataset, rosbag
    from locus_tpu_torch.sync import ApproximateTimeSync

    sync = ApproximateTimeSync(list(names), slop=HUSKY_SLOP_S, liveness_timeout=LIDAR_TIMEOUT_S)
    scans, heard, stamps, odo_s, odo_p = [], [], [], [], []
    for msg in rosbag.read_bag(str(path)):
        if msg.msg_type == "nav_msgs/Odometry":
            d = rosbag.decode_odometry(msg.raw)
            odo_s.append(d["stamp"])
            odo_p.append(d["pose"])
            continue
        d = rosbag.decode_pointcloud2(msg.raw)
        heard.append((names.index(d["frame_id"]), d["stamp"]))
        tup = sync.push(d["frame_id"], d["stamp"], d["xyz"])
        if tup is not None:
            scans.append({"heard": heard, "now": d["stamp"],
                          "clouds": {names.index(n): xyz for n, (_, xyz) in tup.items()}})
            stamps.append(min(t for t, _ in tup.values()))
            heard = []
    # a tuple's sweep: its stamp less the sweep's jitter, at 10 Hz
    sweeps = np.rint((np.asarray(stamps) - HUSKY_T0 - HUSKY_JITTER_S / 2) * 10.0).astype(int)
    if not np.array_equal(sweeps, np.arange(len(gt))):
        raise RuntimeError(f"the synchronizer did not emit one tuple a sweep: {sweeps.tolist()}")
    t0 = stamps[0]
    seq = dataset.Sequence(scans=np.zeros((len(scans), 1, 3), np.float32), scan_valid=np.zeros((len(scans), 1), bool),
                           stamps=np.asarray(stamps) - t0, gt_poses=gt[sweeps],
                           odom_stamps=np.asarray(odo_s) - t0, odom_poses=np.stack(odo_p))
    return scans, seq


def husky_step(torch, np, cfg, scans, seq, lidars, dev):
    """step(state, mstate, i) -> (state, mstate, out, merged point count,
    alive flags): scan i's heartbeats into the merger state, the lidars'
    health when its tuple completed, the merge on `dev` (each lidar in a
    slot of raw_scan_capacity // L points, dead or silent lidars masked
    out) and one pipeline step. Neither input state is modified."""
    from locus_tpu_torch import merger, runner
    from locus_tpu_torch.core.cloud import PointCloud
    from locus_tpu_torch.io.dataset import sensor_windows_for_scan

    ext = list(lidars.values())
    slot = cfg.raw_scan_capacity // len(ext)

    def step(state, mstate, i):
        (imu_s, imu_q), (odom_s, odom_p) = sensor_windows_for_scan(seq, i)
        host = (np.float32(seq.stamps[i]), imu_s, imu_q, odom_s, odom_p, np.int32(i))
        for k, stamp in scans[i]["heard"]:
            mstate = merger.observe(mstate, k, stamp)
        alive = merger.health(mstate, scans[i]["now"], timeout=LIDAR_TIMEOUT_S)
        clouds = [PointCloud.from_points(scans[i]["clouds"][k], capacity=slot, device=dev)
                  if k in scans[i]["clouds"] else PointCloud.empty(slot, device=dev) for k in range(len(ext))]
        merged = merger.merge(clouds, ext, alive, cfg.merger, capacity=cfg.raw_scan_capacity)
        state, out = runner.replay_step(state, merged.xyz, merged.mask,
                                        *(torch.as_tensor(a).to(dev) for a in host), cfg=cfg)
        return state, mstate, out, merged.count(), alive

    return step


def husky_init(torch, cfg, seq, lidars, dev):
    """The pipeline and merger states before the first husky scan."""
    from locus_tpu_torch import merger, pipeline

    state = pipeline.init_state_from_config(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32),
                                            device=dev)
    return state, merger.init_state(len(lidars), device=dev)


def husky_replay(torch, np, cfg, scans, seq, lidars, dev, max_scans=None, report=None):
    """`husky_step` over the parsed husky scans. With a report, each scan's
    merge and step are timed up to a device synchronisation. Returns
    (poses (n,4,4) float64, outputs, merged point counts (n,), alive flags
    (n,L), final state)."""
    step = husky_step(torch, np, cfg, scans, seq, lidars, dev)
    state, mstate = husky_init(torch, cfg, seq, lidars, dev)
    outs, counts, alives = [], [], []
    for i in range(len(scans) if max_scans is None else max_scans):
        t0 = time.perf_counter()
        state, mstate, out, count, alive = step(state, mstate, i)
        if report is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            report.add(time.perf_counter() - t0)
        outs.append(out)
        counts.append(count)
        alives.append(alive)
    poses = np.stack([o.pose.cpu().numpy().astype(np.float64) for o in outs])
    return poses, outs, torch.stack(counts).cpu().numpy(), torch.stack(alives).cpu().numpy(), state


def husky_data(np, workdir, num_scans=HUSKY_SCANS, azimuth=HUSKY_AZIMUTH, dead_scans=HUSKY_DEAD_SCANS, workers=6):
    """The husky bag written to `workdir` and parsed: a dict of the lidars'
    extrinsics, the parsed scans and sequence (`read_husky_bag`), the
    silent scans, the bag's size and the seconds each part took."""
    lidars = husky_extrinsics()
    t0 = time.perf_counter()
    bag = workdir / "husky.bag"
    gt = write_husky_bag(np, bag, lidars, num_scans, azimuth, dead_scans, workers=workers)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scans, seq = read_husky_bag(np, bag, list(lidars), gt)
    return {"lidars": lidars, "scans": scans, "seq": seq, "dead_scans": dead_scans, "azimuth_steps": azimuth,
            "bag_bytes": bag.stat().st_size, "bag_write_s": write_s, "bag_parse_s": time.perf_counter() - t0}


def run_husky(torch, np, cfg, dev, data, alive_by=HUSKY_ALIVE_BY, ab_scans=REF_SCANS):
    """The husky phase on `data` (`husky_data`): a plain-version reference
    of the first `ab_scans` scans, then the whole replay through the
    kernels with launch counts reset just before and read just after.
    Returns the phase record, the poses and the reference's final state
    with the merged cloud of the scan after it (the kernels' inputs)."""
    from locus_tpu_torch.metrics import RateReport
    from locus_tpu_torch.ops import dispatch
    from locus_tpu_torch.ops.kernels import read_launches, reset_launches

    lidars, scans, seq, dead_scans = data["lidars"], data["scans"], data["seq"], data["dead_scans"]
    with dispatch.no_kernels():
        ref_poses, *_, ref_state = husky_replay(torch, np, cfg, scans, seq, lidars, dev, max_scans=ab_scans)
    report = RateReport()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    poses, outs, merged, alive, _ = husky_replay(torch, np, cfg, scans, seq, lidars, dev, report=report)
    wall = time.perf_counter() - t0
    launches = read_launches()
    dur = np.asarray(report.durations)
    window = dur[-RATE_WINDOW:]
    ate, final = trajectory_errors(np, poses, seq.gt_poses)
    ab = np.abs(poses[:ab_scans, :3, 3] - ref_poses[:, :3, 3]).max(axis=1)
    one = np.asarray([len(s["clouds"][0]) for s in scans])           # the front lidar's points
    dead = np.zeros(len(scans), bool)
    dead[dead_scans[0]: dead_scans[1] + 1] = True
    all_alive = alive.all(axis=1)
    record = {
        "phase": "husky", "scans": len(scans), "lidars": list(lidars), "captured": False,   # the eager replay_step
        **{k: data[k] for k in ("azimuth_steps", "bag_bytes", "bag_write_s", "bag_parse_s")}, "wall_s": wall,
        "scans_per_s_last32": window.size / float(window.sum()),
        "ms_per_scan_p50_last32": float(np.median(window) * 1e3), "ms_per_scan_max_last32": float(window.max() * 1e3),
        "first_scan_s": float(dur[0]), "ate_m": ate, "final_error_m": final,
        "alive": alive.astype(int).tolist(), "dead_scans": list(dead_scans),
        "lidar_dead_where_silent": bool(not alive[dead, HUSKY_DEAD_LIDAR].any()),
        "lidar_alive_again_by": alive_by, "lidar_alive_from_then": bool(alive[alive_by:, HUSKY_DEAD_LIDAR].all()),
        "others_always_alive": bool(np.delete(alive, HUSKY_DEAD_LIDAR, axis=1).all()),
        "merged_points_per_scan": merged.tolist(),
        "merged_points_mean_all_alive": float(merged[all_alive].mean()),
        "merged_points_mean_dropout": float(merged[~all_alive].mean()) if (~all_alive).any() else None,
        "front_lidar_points_mean": float(one.mean()),
        "merged_over_twice_one_lidar": bool((merged[all_alive] > 2 * one[all_alive]).all()),
        "launches": launches, "launches_per_scan": {k: v / len(scans) for k, v in launches.items()},
        "keyframes": int(sum(bool(o.keyframe_inserted) for o in outs)),
        "final_map_size": int(outs[-1].map_size), "mean_points": float(np.mean([int(o.num_points) for o in outs])),
        "ab_scans": ab_scans, "ab_max_translation_m": float(ab.max()), "ab_per_scan_m": ab.tolist(),
    }
    if dev.type == "cuda":
        record["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return record, poses, (ref_state, scans[ab_scans], lidars)


def husky_kernel_inputs(torch, cfg, ref, dev):
    """The merged cloud of the scan after the reference run, all lidars
    alive, cropped and voxelised at the reference state's leaf: the
    kernels' inputs on the husky path; with the reference state and the
    merged cloud (B7's inputs come from it)."""
    from locus_tpu_torch import merger
    from locus_tpu_torch.core.cloud import PointCloud

    state, scan, lidars = ref
    slot = cfg.raw_scan_capacity // len(lidars)
    clouds = [PointCloud.from_points(scan["clouds"][k], capacity=slot, device=dev) for k in range(len(lidars))]
    alive = torch.ones(len(lidars), dtype=torch.bool, device=dev)
    merged = merger.merge(clouds, list(lidars.values()), alive, cfg.merger, capacity=cfg.raw_scan_capacity)
    return cloud_for_checks(cfg, merged, state.voxel_leaf), state, merged


def husky_problems(record):
    problems = []
    if not math.isfinite(record["ate_m"]) or record["ate_m"] > ATE_LIMIT_M:
        problems.append(f"husky: ATE {record['ate_m']} m exceeds {ATE_LIMIT_M} m")
    if not (record["lidar_dead_where_silent"] and record["lidar_alive_from_then"] and record["others_always_alive"]):
        problems.append(f"husky: lidar health is not dead on {record['dead_scans']} and alive from scan "
                        f"{record['lidar_alive_again_by']}: {record['alive']}")
    if not record["merged_over_twice_one_lidar"]:
        problems.append("husky: a merged scan of three live lidars holds no more than twice one lidar's points")
    if min(record["launches"][k] for k in SINGLE_PATH) <= 0:
        problems.append(f"husky: the replay did not launch {SINGLE_PATH}: {record['launches']}")
    if record["ab_max_translation_m"] > AB_LIMIT_M:
        problems.append(f"husky: kernels and plain versions differ by {record['ab_max_translation_m']} m")
    return problems


def run_ranks(workdir, name, world, *args, timeout=RANK_TIMEOUT_S):
    """tools/torch_dist_smoke.py as `world` ranks on the card, collectives
    through gloo; rank 0's record (every rank's under "ranks") with the
    seconds the launch took. A rank that fails or a launch past `timeout`
    ends every rank and raises."""
    from locus_tpu_torch.parallel.distributed import spawn_ranks

    out = workdir / name
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, str(ROOT / "tools" / "torch_dist_smoke.py"), *map(str, args), "--device", "cuda",
           "--backend", "gloo", "--out", str(out), "--timeout", str(timeout)]
    t0 = time.perf_counter()
    results = spawn_ranks(cmd, world, out / "ranks", timeout, cwd=ROOT)
    failed = [f"rank {r} exited {rc}: {err[-3000:]}" for r, (rc, _, err) in enumerate(results) if rc != 0]
    if failed:
        raise RuntimeError(f"{name}: " + "; ".join(failed))
    rec = json.loads(results[0][1].strip().splitlines()[-1])
    rec["launch_s"] = time.perf_counter() - t0
    return rec


def per_rank(rec, *keys):
    """{key: [each rank's value]} of a ranks record."""
    return {k: [r[k] for r in rec["ranks"]] for k in keys}


def run_sharded(np, workdir, seq, poses, sizes, cfg):
    """Phase 13 on `seq` against phase 5's `poses` and map `sizes`. The
    ranks' inputs and checkpoints go to `workdir`/RANK_INPUTS."""
    seq_path, ref_path = workdir / RANK_INPUTS / "production_seq.npz", workdir / RANK_INPUTS / "production_ref.npz"
    seq.save(str(seq_path))
    np.savez(ref_path, poses=poses, sizes=np.asarray(sizes))
    common = ("--profile", "production", "--seq", seq_path, "--window", RATE_WINDOW)
    run = run_ranks(workdir, "sharded", SHARDED_RANKS, "--mode", "pipeline", "--ref", ref_path, *common)
    ck = workdir / RANK_INPUTS / "sharded_ck"
    saved = run_ranks(workdir, "sharded_save", SHARDED_RANKS, "--mode", "ckpt_save", "--ckpt", ck,
                      "--resume-at", SHARDED_RESUME_AT, *common)
    resumed = run_ranks(workdir, "sharded_resume", SHARDED_RANKS, "--mode", "ckpt_resume", "--ckpt", ck,
                        "--resume-at", SHARDED_RESUME_AT, "--ref", workdir / "sharded" / "pipeline_poses.npz",
                        "--trace-collectives", *common)
    return {
        "phase": "sharded", "scans": len(seq), "mesh": run["mesh"], "backend": run["backend"], "captured": False,
        "device_name": run.get("device_name"), "map_capacity": cfg.mapper.map_capacity,
        "max_translation_vs_single_m": max(r["max_translation_err_m"] for r in run["ranks"]),
        "max_pose_entry_vs_single": run["max_pose_err"], "bit_equal_vs_single": run["bit_equal"],
        "map_sizes_equal": run["map_sizes_equal"], "final_map_size": run["final_map_size"],
        **per_rank(run, "scans_per_s_last", "ms_p50_last", "ms_max_last", "wall_s", "map_operand_rows",
                   "local_map_points", "launches", "launches_per_scan"),
        "rate_window": RATE_WINDOW, "launch_s": run["launch_s"],
        "resume": {"at": SHARDED_RESUME_AT, "saved": saved["wrote"], "resumed_scans": resumed["resumed_scans"],
                   "bit_equal": resumed["bit_equal"], "max_pose_entry": resumed["max_pose_err"],
                   "map_sizes_equal": resumed["map_sizes_equal"],
                   "launch_s": [saved["launch_s"], resumed["launch_s"]]},
        "traced": per_rank(resumed, "collective_ms_per_step", "collectives_per_step", "ms_p50_last"),
    }


def sharded_problems(record, cap):
    problems = []
    if record["max_translation_vs_single_m"] > SHARDED_LIMIT_M or not record["map_sizes_equal"]:
        problems.append(f"sharded: {record['max_translation_vs_single_m']} m from the single replay, "
                        f"map sizes equal {record['map_sizes_equal']}")
    if any(n != cap // SHARDED_RANKS for n in record["map_operand_rows"]):
        problems.append(f"sharded: map operands of {record['map_operand_rows']} rows, not {cap // SHARDED_RANKS}")
    for r, launches in enumerate(record["launches"]):
        if min(launches[k] for k in SINGLE_PATH) <= 0 or any(launches[k] for k in BATCHED_PATH):
            problems.append(f"sharded: rank {r} did not launch {SINGLE_PATH} alone: {launches}")
    if not record["resume"]["bit_equal"]:
        problems.append("sharded: the ranks resumed from their checkpoints did not repeat the run bit for bit")
    return problems


def run_sharded_batched(np, workdir, robot_seqs, single_poses):
    """Phase 14: the robots of phase 7 on a (2, 2) mesh against their
    single replays `single_poses` (B of (T, 4, 4))."""
    paths = []
    for b, s in enumerate(robot_seqs):
        paths.append(str(workdir / RANK_INPUTS / f"robot{b}.npz"))
        s.save(paths[-1])
    ref = workdir / RANK_INPUTS / "robots_ref.npz"
    np.savez(ref, poses=np.stack(single_poses, axis=1))
    run = run_ranks(workdir, "sharded_batched", SHARDED_BATCHED_RANKS, "--mode", "dp", "--map-parallel",
                    SHARDED_RANKS, "--profile", "production", "--seq", ",".join(paths), "--ref", ref,
                    "--window", TICK_WINDOW)
    return {
        "phase": "sharded_batched", "robots": len(robot_seqs), "mesh": run["mesh"], "backend": run["backend"],
        "captured": False,
        "owned_rows": run["owned_rows"], "max_pose_entry_vs_single": run["max_pose_err"],
        "bit_equal_vs_single": run["bit_equal"],
        "max_translation_vs_single_m": max(r["max_translation_err_m"] for r in run["ranks"]),
        **per_rank(run, "scans_per_s_last", "ms_p50_last", "ms_max_last", "wall_s", "map_operand_rows",
                   "launches", "launches_per_tick", "final_map_sizes"),
        "tick_window": TICK_WINDOW, "launch_s": run["launch_s"],
    }


def sharded_batched_problems(record, cap):
    problems = []
    if record["max_translation_vs_single_m"] > SHARDED_LIMIT_M:
        problems.append(f"sharded_batched: robots {record['max_translation_vs_single_m']} m from their single replays")
    if any(n != cap // SHARDED_RANKS for n in record["map_operand_rows"]):
        problems.append(f"sharded_batched: map operands of {record['map_operand_rows']} rows")
    for r, launches in enumerate(record["launches"]):
        if min(launches[k] for k in BATCHED_PATH) <= 0 or any(launches[k] for k in SINGLE_PATH):
            problems.append(f"sharded_batched: rank {r} did not launch {BATCHED_PATH} alone: {launches}")
    return problems


def run_sharded_live(np, workdir, circuit, live_poses):
    """Phase 15: the live circuit served on SHARDED_RANKS ranks against
    phase 9's poses."""
    seq_path, ref = workdir / RANK_INPUTS / "circuit.npz", workdir / RANK_INPUTS / "live_ref.npz"
    circuit.save(str(seq_path))
    np.savez(ref, poses=live_poses)
    run = run_ranks(workdir, "sharded_live", SHARDED_RANKS, "--mode", "live", "--closures", "--profile",
                    "production", "--seq", seq_path, "--ref", ref)
    return {
        "phase": "sharded_live", "scans": len(circuit), "mesh": run["mesh"], "backend": run["backend"],
        "captured": False,
        **{k: run[k] for k in ("closures_pushed_back", "ate_m", "max_translation_err_before_first_closure_m",
                               "max_pose_err_before_first_closure", "max_translation_err_m", "ranks_agree")},
        **per_rank(run, "push_back_scans", "loops_found", "latency_ms_p50", "latency_ms_max", "slowest_scans",
                   "launches", "launches_per_scan"),
        "launch_s": run["launch_s"],
    }


def sharded_live_problems(record):
    problems = []
    if record["max_translation_err_before_first_closure_m"] > SHARDED_LIMIT_M:
        problems.append(f"sharded_live: {record['max_translation_err_before_first_closure_m']} m from phase 9 "
                        "before the first closure")
    if not math.isfinite(record["ate_m"]) or record["ate_m"] > ATE_LIMIT_M:
        problems.append(f"sharded_live: ATE {record['ate_m']} m exceeds {ATE_LIMIT_M} m")
    if record["closures_pushed_back"] < 1 or not record["ranks_agree"]:
        problems.append(f"sharded_live: {record['closures_pushed_back']} closures, ranks agree {record['ranks_agree']}")
    for r, launches in enumerate(record["launches"]):
        if min(launches[k] for k in SINGLE_PATH) <= 0:
            problems.append(f"sharded_live: rank {r} did not launch {SINGLE_PATH}: {launches}")
    return problems


def tool_commands(workdir):
    """(name, script, arguments) of each tool run of phase 16, at the sizes
    that keep the phase within a few minutes (the benchmark at its full
    protocol, the eval suite at its 60 scans a world; the latency bench and
    the collective budget on fewer scans)."""
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    drops_in = workdir / "drops_in.npz"
    make_tunnel_sequence(num_scans=20, azimuth_steps=64, seed=0).save(str(drops_in))
    gaps = [a for flag, gap in DROP_GAPS for a in (flag, gap)]
    bts = ",".join(map(str, NN_BENCH_BTS))
    return [
        ("bench", "torch_bench.py", []),
        ("eval_suite", "torch_eval_suite.py", ["--scans", EVAL_SCANS]),
        ("latency_bench", "torch_latency_bench.py", ["--scans", LATENCY_SCANS]),
        ("profiler", "torch_profiler.py", []),
        ("simulate_sensor_drops", "torch_simulate_sensor_drops.py", [drops_in, workdir / "drops_out.npz", *gaps]),
        ("memory_report", "torch_memory_report.py", []),
        ("nn_bench", "torch_nn_bench.py", ["--bt", bts]),
        ("nn_bench_voxel_hash", "torch_nn_bench.py", ["--bt", 2048, "--operand", "voxel_hash"]),
        ("nn_bench_shards", "torch_nn_bench.py", ["--bt", 2048, "--shards", 2]),
        ("scaling_bench", "torch_scaling_bench.py", ["--ranks", 1, 2, 4, "--production"]),
        ("collective_budget", "torch_collective_budget.py", ["--ranks", 2, "--scans", COLLECTIVE_SCANS]),
        *((name, script, args) for name, (script, args, _) in EXPERIMENTS.items()),
        ("quickstart", "../examples/torch_quickstart.py", ["--scans", QUICKSTART_SCANS]),
    ]


def run_tool(name, script, args, workdir, timeout=TOOL_TIMEOUT_S):
    """One tool in a process group of its own (its ranks included), ended
    at `timeout`: (exit code, seconds, its JSON record or None, stderr's
    tail)."""
    import os
    import signal

    out = workdir / f"{name}.json"
    out.unlink(missing_ok=True)
    argv = [sys.executable, str(ROOT / "tools" / script), *map(str, args)]
    if name not in ("simulate_sensor_drops", "quickstart"):
        argv += ["--json", str(out)]
    t0 = time.perf_counter()
    with open(workdir / f"{name}.out", "w") as so, open(workdir / f"{name}.err", "w+") as se:
        proc = subprocess.Popen(argv, stdout=so, stderr=se, cwd=ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            rc = 124
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)   # the tool's ranks too
            except ProcessLookupError:
                pass
            proc.wait()
        se.seek(0)
        err = se.read()[-3000:]
    record = json.loads(out.read_text()) if out.exists() else None
    return rc, time.perf_counter() - t0, record, err


def run_tools(np, workdir):
    """Phase 16: every tool of `tool_commands`; returns the phase record
    (each tool's exit code, seconds and JSON) after emitting each tool's
    line."""
    from locus_tpu_torch.io.dataset import Sequence

    workdir.mkdir(parents=True, exist_ok=True)
    tools = {}
    for name, script, args in tool_commands(workdir):
        rc, seconds, result, err = run_tool(name, script, args, workdir)
        if name == "simulate_sensor_drops" and rc == 0:
            src, dst = Sequence.load(str(args[0])), Sequence.load(str(args[1]))
            result = {"odom_samples": [len(src.odom_stamps), len(dst.odom_stamps)],
                      "imu_samples": [len(src.imu_stamps), len(dst.imu_stamps)],
                      "scans_kept": bool(np.array_equal(src.scans, dst.scans))}
        if name == "quickstart" and rc == 0:
            result = quickstart_result(workdir / f"{name}.out")
        tools[name] = {"rc": rc, "seconds": seconds, "result": result} | ({"stderr_tail": err} if rc else {})
        # the steps the tool ran as CUDA graphs (its device record), None where it keeps no record
        captured = (result or {}).get("captured")
        emit({"phase": "tools", "tool": name, "captured": captured} | tools[name])
    return {"phase": "tools", "tools": {
        k: {"rc": v["rc"], "seconds": v["seconds"], "launches": tool_run_launches(k, v["result"])}
        for k, v in tools.items()}}, tools


def quickstart_result(path):
    """The quickstart's printed lines ("rate: x Hz", "ATE: x m",
    "keyframes: n", "map points: n") as a record."""
    out = {}
    for line in path.read_text().splitlines():
        key, _, value = line.partition(":")
        if key in ("rate", "ATE", "keyframes", "map points"):
            out[key.replace(" ", "_")] = float(value.split()[0])
    return out


def experiment_rows(name, result):
    """An experiment's row of each variant (tools/torch_exp_*.py: exp_ablate
    and exp_steady keep them under "rows", the others beside the JAX
    tool's other keys)."""
    rows = result.get("rows", result) if name in ("exp_ablate", "exp_steady") else result
    return {v: rows[v] for v in EXPERIMENTS[name][2] if isinstance(rows.get(v), dict)}


def tool_run_launches(name, result):
    """The launch counts of a tool's main run, one dict a process (a rank
    tool's ranks, over its rank counts) or an experiment's variant, each
    counted from 0 by the tool."""
    if not result:
        return []
    if name in EXPERIMENTS:
        return [row["launches"] for row in experiment_rows(name, result).values()]
    if name == "scaling_bench":
        return [ranks for row in result["results"].values() for ranks in row["launches_per_rank"]]
    if name == "collective_budget":
        return result["launches_per_rank"]
    return [result["launches"]] if "launches" in result else []


def tools_problems(tools, pipeline_poses):
    """What fails phase 16 (`pipeline_poses`: phase 5's)."""
    problems = []
    for name, t in tools.items():
        r = t["result"]
        if t["rc"] != 0 or r is None:
            problems.append(f"tools: {name} exited {t['rc']}: {t.get('stderr_tail', '')[-500:]}")
        elif name not in ("simulate_sensor_drops", "quickstart") and not (r.get("device") and r.get("power_limit_w")):
            problems.append(f"tools: {name} names no card or power limit: {r.get('device')}, {r.get('power_limit_w')}")
    ok = {name: t["result"] for name, t in tools.items() if t["rc"] == 0 and t["result"] is not None}
    if "bench" in ok and not ok["bench"]["ate_m"] <= ATE_LIMIT_M:
        problems.append(f"tools: bench ATE {ok['bench']['ate_m']} m exceeds {ATE_LIMIT_M} m")
    for world, row in ok.get("eval_suite", {}).get("worlds", {}).items():
        if not row["ate_m"] <= ATE_LIMIT_M:
            problems.append(f"tools: eval world {world} ATE {row['ate_m']} m exceeds {ATE_LIMIT_M} m")
        if world == "loop" and row.get("loop_closures", 0) < 1:
            problems.append("tools: the eval suite's loop world closed no loop")
    for name in ("nn_bench", "nn_bench_voxel_hash", "nn_bench_shards"):
        if name in ok and not ok[name]["bit_equal"]:
            problems.append(f"tools: a timed B2 launch of {name} differs from its plain version")
    if "scaling_bench" in ok and not ok["scaling_bench"]["poses_equal_single_rank"]:
        problems.append("tools: the scaling bench's poses part from its 1-rank run")
    if "collective_budget" in ok and not ok["collective_budget"]["computed_equals_counted"]:
        problems.append("tools: the collective budget's computed bytes differ from its counted bytes")
    for name, kernels in TOOL_KERNELS.items():
        runs = tool_run_launches(name, ok.get(name))
        if name in ok and not (runs and all(run.get(k, 0) > 0 for run in runs for k in kernels)):
            problems.append(f"tools: {name}'s main run did not launch {kernels}: {runs}")
    for name, (_, _, variants) in EXPERIMENTS.items():
        if name in ok:
            missing = sorted(set(variants) - set(experiment_rows(name, ok[name])))
            if missing:
                problems.append(f"tools: {name} has no row for {missing}")
    if "exp_gap" in ok:
        gap = experiment_pose_gap(ok["exp_gap"], pipeline_poses)
        ok["exp_gap"]["default_vs_pipeline_m"] = gap
        if not gap <= EXP_POSE_LIMIT_M:
            problems.append(f"tools: exp_gap's default variant lies {gap} m from phase 5's poses")
    for world in ("tunnel", "urban", "cave"):
        ate = ok["exp_inner"]["inner3"].get(f"ate_{world}", math.inf) if "exp_inner" in ok else 0.0
        if not ate <= ATE_LIMIT_M:
            problems.append(f"tools: exp_inner's inner-3 {world} ATE {ate} m exceeds {ATE_LIMIT_M} m")
    quick = ok.get("quickstart")
    if quick is not None and not (quick.get("ATE", math.inf) <= ATE_LIMIT_M and quick.get("map_points", 0) > 0):
        problems.append(f"tools: the quickstart's run: {quick}")
    drops = ok.get("simulate_sensor_drops")
    if drops and not (drops["odom_samples"][1] < drops["odom_samples"][0]
                      and drops["imu_samples"][1] < drops["imu_samples"][0] and drops["scans_kept"]):
        problems.append(f"tools: the sensor-drop copy dropped no samples or changed the scans: {drops}")
    return problems


def experiment_pose_gap(result, pipeline_poses):
    """The largest translation gap (m) between an experiment's default
    poses (its replay from a fresh state) and phase 5's for the same
    scans."""
    import numpy as np

    poses = np.asarray(result["default_poses"], np.float64)
    ref = np.asarray(pipeline_poses, np.float64)[: poses.shape[0]]
    return float(np.linalg.norm(poses[:, :3, 3] - ref[:, :3, 3], axis=1).max())


def trace_steps(torch, step, state, inputs):
    """`step(state, *args)` over `inputs` from `state` under torch.profiler:
    the traced wall time, the device's busy time (every kernel, copy and
    set on the card) and what the host issued, per scan."""
    from torch.profiler import ProfilerActivity, profile

    n = len(inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for args in inputs:
            state, _ = step(state, *args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    host = {e.key: e.count for e in events if e.device_type != cuda}

    def own_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    work = [e for e in events if e.device_type == cuda and not e.key.startswith("stage_") and own_us(e) > 0]
    return {
        "traced_scans": n, "traced_wall_ms_per_scan": wall * 1e3 / n,
        "device_busy_ms_per_scan": sum(own_us(e) for e in work) / 1e3 / n,
        "device_ops_per_scan": sum(e.count for e in work) / n,
        "host_kernel_launches_per_scan": sum(host.get(k, 0) for k in COMPILED_LAUNCHES) / n,
        "graph_launches_per_scan": host.get("cudaGraphLaunch", 0) / n,
        "memcpy_calls_per_scan": host.get("cudaMemcpyAsync", 0) / n,
        "syncs_per_scan": sum(host.get(k, 0) for k in COMPILED_SYNCS) / n,
    }


def run_compiled(torch, np, runner, pipeline, cfg, seq, pipeline_rec, captured_poses, dev):
    """Phase 5's scans again through the eager `runner.replay_step`, in the
    same call: poses, ATE, launches and rate beside phase 5's captured
    replay, then the last COMPILED_TRACE scans of each traced from the same
    state. Returns the phase record."""
    from locus_tpu_torch.metrics import ate_rmse
    from locus_tpu_torch.ops.kernels import read_launches, reset_launches

    n = len(seq)
    inputs = [runner.scan_inputs(seq, i, cfg, dev) for i in range(n)]
    eager = functools.partial(runner.replay_step, cfg=cfg)
    state = pipeline.init_state_from_config(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32),
                                            device=dev)
    first = n - COMPILED_TRACE
    poses, dur = [], []
    torch.cuda.synchronize()
    reset_launches()
    for i, args in enumerate(inputs):
        if i == first:
            start = state          # the eager step leaves its input state as it was
        t0 = time.perf_counter()
        state, out = eager(state, *args)
        torch.cuda.synchronize()
        dur.append(time.perf_counter() - t0)
        poses.append(out.pose)
    launches = read_launches()
    poses = torch.stack(poses).cpu().numpy().astype(np.float64)
    dur = np.asarray(dur)
    ate = ate_rmse(poses[:, :3, 3], seq.gt_poses[:n, :3, 3], align=False)
    eager_rate = RATE_WINDOW / float(dur[-RATE_WINDOW:].sum())
    # the traced windows: the captured step is captured on its first call,
    # before its window, and takes the eager run's state there
    rstep = runner.make_replay_step(cfg)
    rstep(start, *inputs[first])
    traced = {"eager": trace_steps(torch, eager, start, inputs[first:]),
              "captured": trace_steps(torch, rstep, start, inputs[first:])}
    for name, ms in (("eager", 1e3 / eager_rate), ("captured", 1e3 / pipeline_rec["scans_per_s_last32"])):
        traced[name]["device_idle_share"] = 1.0 - traced[name]["device_busy_ms_per_scan"] / ms
    return {
        "phase": "compiled", "scans": n, "captured": pipeline_rec["captured"],
        "scans_per_s_last32": {"captured": pipeline_rec["scans_per_s_last32"], "eager": eager_rate},
        "captured_over_eager": pipeline_rec["scans_per_s_last32"] / eager_rate,
        "ate_m": {"captured": pipeline_rec["ate_m"], "eager": ate},
        "max_pose_diff": float(np.abs(captured_poses - poses).max()),
        "launches_per_scan": {"captured": pipeline_rec["launches_per_scan"],
                              "eager": {k: v / n for k, v in launches.items()}},
        "launches_equal": pipeline_rec["launches"] == launches,
        "capture_seconds": rstep.setup_seconds,
        "traced": traced,
    }


def compiled_problems(record):
    problems = []
    if record["max_pose_diff"] != 0.0:
        problems.append(f"compiled: captured and eager poses differ by {record['max_pose_diff']}")
    if record["ate_m"]["captured"] != record["ate_m"]["eager"]:
        problems.append(f"compiled: ATE captured {record['ate_m']['captured']} != eager {record['ate_m']['eager']}")
    if not record["launches_equal"]:
        problems.append(f"compiled: launches differ: {record['launches_per_scan']}")
    return problems


def run_batched_captured(torch, np, runner, pipeline, cfg, packed, init_poses, captured_poses, dev):
    """Phase 7's ticks again through the eager batched step (the kernels
    on), in this call: its poses against the captured replay's; then a
    captured batched step from the eager run's state COMPILED_TRACE ticks
    before the end, its later ticks traced. Returns the phase row."""
    outs = []
    ticks = packed["scan_xyz"].shape[0]
    first = ticks - COMPILED_TRACE
    inputs = [[packed[k][i] for k in runner.PACKED_KEYS] for i in range(ticks)]
    state = pipeline.init_states(cfg, init_poses, device=dev)
    t0 = time.perf_counter()
    for i, args in enumerate(inputs):
        if i == first:
            start = state          # the eager step leaves its input state as it was
        state, out = runner.replay_step(state, *args, cfg=cfg)
        outs.append(out.pose)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = torch.stack(outs).cpu().numpy().astype(np.float64)
    # the capture takes the eager run's state there; the traced ticks go on
    # from the graph's own (a state from outside is copied in, a tick is not)
    rstep = runner.make_replay_step(cfg, name=runner.BATCHED_REPLAY_STEP)
    state, _ = rstep(start, *inputs[first])
    traced = trace_steps(torch, rstep, state, inputs[first + 1:])
    return {
        "phase": "batched_captured", "ticks": ticks, "eager_ms_per_tick": eager_s * 1e3 / ticks,
        "max_pose_diff_captured_vs_eager": float(np.abs(captured_poses - eager).max()),
        "capture_seconds": rstep.setup_seconds, "traced": traced,
    }


def batched_captured_problems(record, batched):
    problems = []
    if not batched["captured"]:
        problems.append("batched: make_batched_replay did not run captured")
    if record["max_pose_diff_captured_vs_eager"] != 0.0:
        problems.append(f"batched: captured and eager poses differ by {record['max_pose_diff_captured_vs_eager']}")
    if max(batched["max_translation_vs_single_m"]) != 0.0:
        problems.append(f"batched: robots differ from their single replays by {batched['max_translation_vs_single_m']}")
    t = record["traced"]
    # the syncs traced: the fence after the ticks and the profiler's own
    if (t["graph_launches_per_scan"], t["host_kernel_launches_per_scan"]) != (1.0, 0.0) or \
            t["syncs_per_scan"] * t["traced_scans"] > 2:
        problems.append(f"batched: a captured tick is not one graph launch and nothing else: {t}")
    return problems


def device_time_ms(torch, fn, reps=20, warmup=3, prepare=None):
    """Median device time of fn() in ms: CUDA events around each call,
    queued behind a sleep kernel so host enqueue time is not measured;
    `prepare()`, if given, runs before each call, outside the events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if prepare is not None:
            prepare()
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
    its members stacked four times. `suffix` names the rows."""
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
    if pc.xyz.dim() == 3:
        name, bt, radius, args, query, target = cases[-1]
        cases.append((f"{name}_b16", bt, radius, tuple(x.repeat((4,) + (1,) * (x.dim() - 1)) for x in args),
                      query.repeat(4, 1, 1), target.repeat(4, 1, 1)))
    return cases


def uncounted(check):
    """`check` with none of its kernel launches recorded
    (`ops.kernels.uncounted`): comparison launches are not main-path
    launches."""
    @functools.wraps(check)
    def run(*args, **kwargs):
        from locus_tpu_torch.ops.kernels import uncounted as nowhere

        with nowhere():
            return check(*args, **kwargs)

    return run


@uncounted
def check_nn(torch, tnn, build, name, bt, radius, args, query, target):
    """Kernel B2 (one member) or B3 (a leading batch) against its plain
    version on one call: score bits and index on every row."""
    cnt, ids, q, t_aug = args
    batched = q.dim() == 3
    run = tnn.nn_visits_batched if batched else tnn.nn_visits
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


@uncounted
def check_moments(torch, tmom, build, query, radius, suffix=""):
    """Kernel B1 (one member) or B4 (a leading batch, one radius each)
    against its plain version on one main-path call, then the dense kernel
    B5 (B6) against its plain version on the same inputs, with the counts
    in which dense and pruned differ (expected only at the f32 radius).
    A single member's rows are named with `suffix`."""
    batched = query.dim() == 3
    r2 = (radius * radius).reshape(-1).to(torch.float32)
    cnt, ids = tmom.prune(query, query, r2)
    q, t = tmom.pack_operands(query, query)
    qd, td = tmom.pack_operands(query, query, bt=tmom.DENSE_BT)
    kinds = ("moments_visits_batched", "moments_dense_batched") if batched else ("moments_visits", "moments_dense")
    names = kinds if batched else tuple(k + suffix for k in kinds)
    pruned = tmom.moments_visits_batched if batched else tmom.moments_visits
    dense = tmom.moments_dense_batched if batched else tmom.moments_dense
    dense_visits = tmom.dense_visits(qd, td)
    runs = (
        (names[0], lambda: pruned(cnt, ids, r2, q, t), lambda: tmom.moments_visits_plain(cnt, ids, r2, q, t),
         q, t, int(cnt.sum()) * tmom.BQ * tmom.MBT),
        (names[1], lambda: dense(r2, qd, td),
         lambda: tmom.moments_visits_plain(*dense_visits, r2, qd, td, tmom.DENSE_BT),
         qd, td, qd.shape[:-1].numel() * td.shape[-2]),
    )
    oks, results, sums = [], [], []
    for kind_name, (name, kernel, plain, qq, tt, visited) in zip(kinds, runs):
        k = kernel()
        torch.cuda.synchronize()
        p = plain()
        ok, err, sum_mismatches, count_mismatches = compare_moments(k, p)
        sums.append(k[..., : query.shape[-2], :])
        inside = int(p[..., 9].sum())
        ms = device_time_ms(torch, kernel)
        plain_ms = device_time_ms(torch, plain, reps=5)
        nbytes = (qq.numel() + tt.numel() + r2.numel()) * 4 + qq.shape[:-1].numel() * tmom.NM * 4
        kind = "visits" if kind_name.startswith("moments_visits") else "dense"
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
            "replaces": MOMENT_SOURCES[kind_name], "batch": query.shape[0] if batched else 1,
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


def raw_for_checks(torch, cfg, seqs, i, dev):
    """Scan i of each sequence as the step receives it: one raw cloud, or
    a batch of them."""
    from locus_tpu_torch import runner

    args = [runner.scan_inputs(s, i, cfg, dev) for s in seqs]
    xyz = torch.stack([a[0] for a in args]).squeeze(0)
    mask = torch.stack([a[1] for a in args]).squeeze(0)
    return runner.raw_cloud(xyz, mask)


def scan_for_checks(torch, cfg, seqs, i, leaf, dev):
    """Scan i of each sequence cropped and voxelised at `leaf`, as the step
    would feed the kernels: one cloud, or a batch of them."""
    return cloud_for_checks(cfg, raw_for_checks(torch, cfg, seqs, i, dev), leaf)


def cloud_for_checks(cfg, raw, leaf):
    """A raw cloud cropped and voxelised at `leaf`, as the step feeds the
    kernels."""
    from locus_tpu_torch.ops import filters, voxel

    pc = filters.crop_box(raw, cfg.filtering.box_min, cfg.filtering.box_max)
    return voxel.voxel_downsample(pc, leaf, capacity=cfg.scan_capacity, with_attributes=False)


def gicp_cases(torch, cfg, raw, state, suffix):
    """The step's two GICP calls on the reference run's state, one robot's
    or a batch's: (row name, source, target, registration config) for
    scan-to-scan (the preprocessed sweep `raw` against the last one, the
    prior left out) and scan-to-submap (against its map neighbours in the
    sensor frame, found as `pipeline.step` finds them)."""
    from locus_tpu_torch import localization, pipeline
    from locus_tpu_torch.mapping.registry import mapper_fabric

    scan = pipeline.preprocess(raw, state.voxel_leaf, cfg, open_space=state.open_space)
    fixed = localization.transform_points_to_fixed_frame(state.loc, scan)
    neighbors = mapper_fabric(cfg.mapper).approx_nearest_neighbors(
        state.map, fixed, radius=cfg.mapper.ann_search_radius)
    submap = localization.transform_points_to_sensor_frame(state.loc, neighbors)
    return ((f"gicp_trip{suffix}", scan, state.odom.reference, cfg.odometry),
            (f"gicp_trip{suffix}_submap", scan, submap, cfg.localization.registration))


@uncounted
def check_gicp(torch, build, name, source, target, rcfg, counter):
    """Kernel B7 against its plain version (`dispatch.no_kernels()`) on one
    GICP call of the step: one trip and the whole registration, every
    output bit for bit. Times: `ms` B7 alone, each launch a first trip on
    a fresh carry; `trip_ms` / `plain_trip_ms` a whole trip (the query
    transform, the 1-NN and B7, or the plain trip with the 1-NN's plain
    version) in a CUDA graph, 2 trips less 1, recorded in masked mode;
    `plain_ms` B7's plain version, the plain trip less its query
    transform and 1-NN in a graph. `counter` names the row's launch
    counts in the `kernels` line."""
    import contextlib
    import dataclasses

    from locus_tpu_torch.geometry import se3
    from locus_tpu_torch.ops import dispatch, graph
    from locus_tpu_torch.ops.kernels import gicp as tgicp
    from locus_tpu_torch.ops.kernels.nn import (SCAN_BT, build_nn_target, chunk_boxes, nearest_bounded_pre,
                                                nearest_bounded_raw)
    from locus_tpu_torch.registration.gicp import gicp_register

    dev, lead, n = source.xyz.device, source.mask.shape[:-1], source.capacity
    rep = dataclasses.replace

    def mode(kernels):
        return contextlib.nullcontext() if kernels else dispatch.no_kernels()

    mismatches, results = {}, {}
    for what, c in (("trip", rep(rcfg, iterations=1, final_correspondence_relookup=False)), ("registration", rcfg)):
        fused = gicp_register(source, target, None, c)
        with mode(False):
            plain = gicp_register(source, target, None, c)
        mismatches[what] = [f for f in fused._fields if not torch.equal(getattr(fused, f), getattr(plain, f))]
        results[what] = (fused, plain)
    fused, plain = results["registration"]
    ok = not any(mismatches.values())

    # B7 alone: the first trip's operands, the carry reset before each launch
    t_aug = build_nn_target(target.xyz, bt=SCAN_BT)
    c_min, c_max = chunk_boxes(target.xyz, target.mask, t_aug.shape[-2], bt=SCAN_BT)
    src0 = torch.where(source.mask[..., None], se3.transform_points(se3.identity(dev), source.xyz), source.xyz)
    _, idx = nearest_bounded_raw(src0, t_aug, c_min, c_max, float(rcfg.corr_dist), bt=SCAN_BT)
    carry = (se3.identity(dev).expand(lead + (4, 4)).contiguous(), torch.zeros(lead, dtype=torch.int32, device=dev),
             torch.full(lead, float("inf"), device=dev), torch.zeros(lead, device=dev),
             torch.zeros(lead, dtype=torch.int32, device=dev), torch.zeros(lead + (n,), dtype=torch.int64, device=dev),
             torch.zeros(lead + (n,), device=dev), torch.ones((), dtype=torch.bool, device=dev))
    fresh = tuple(x.clone() for x in carry)
    clouds = tuple(tuple(x.contiguous() for x in (c.xyz, c.normals, c.mask)) for c in (source, target))

    def restart():
        for x, y in zip(carry, fresh):
            x.copy_(y)

    ms = device_time_ms(torch, lambda: tgicp.gicp_trip(src0, idx, *clouds, carry, rcfg), prepare=restart)

    def graph_ms(fn, kernels):
        """Median device time of a CUDA graph of fn(), recorded in masked
        mode after one call on the capture stream."""
        stream, cuda_graph = torch.cuda.Stream(dev), torch.cuda.CUDAGraph()
        with mode(kernels), graph.masked():
            with torch.cuda.stream(stream):
                fn()
            torch.cuda.synchronize(dev)
            with torch.cuda.graph(cuda_graph, stream=stream):
                fn()
        return device_time_ms(torch, cuda_graph.replay)

    def trips(k):
        return lambda: gicp_register(source, target, None, rep(rcfg, iterations=k, **GICP_NEVER))

    def query_and_nn():   # the plain trip's query transform and 1-NN (`nearest_fn`)
        p = se3.transform_points(carry[0], src0)
        d2, j = nearest_bounded_pre(p, t_aug, target.xyz, c_min, c_max, float(rcfg.corr_dist), bt=SCAN_BT)
        return torch.where(torch.isfinite(d2), d2, 1e12), j

    trip_ms = graph_ms(trips(2), True) - graph_ms(trips(1), True)
    plain_trip_ms = graph_ms(trips(2), False) - graph_ms(trips(1), False)
    plain_ms = plain_trip_ms - graph_ms(query_and_nn, False)
    grid, threads, _ = tgicp.launch_grid(lead.numel())
    # per point: ~92 operations for its pair, weight and disk inverse, ~117
    # an inner step (the 27 terms and their sums); 78 bytes read and
    # written (the point, its normal, mask and 1-NN index, the pair's
    # target point, normal and mask; the pair and distance out)
    b, by = bound_ms(source.mask.numel() * (92 + 117 * rcfg.inner_iterations), source.mask.numel() * 78)
    return ok, {
        "name": name, "route": "cuda", "source": "locus_tpu_torch/csrc/gicp.cu",
        "replaces": "none: the JAX trip is XLA-fused (locus_tpu/registration/gicp.py, the lax.while_loop body)",
        "batch": lead.numel(), "grid": list(grid), "threads": threads, "points": n,
        "valid_points": source.mask.sum(-1).tolist(), "targets": target.capacity,
        "valid_targets": target.mask.sum(-1).tolist(), "inner_iterations": rcfg.inner_iterations,
        "iterations": fused.iterations.tolist(), "mismatches": mismatches,
        "max_abs_err": float((fused.transform - plain.transform).abs().max()),
        "tolerance": "every output of one trip and of the whole registration bit for bit",
        "ms": ms, "plain_ms": plain_ms, "trip_ms": trip_ms, "plain_trip_ms": plain_trip_ms,
        "bound_ms": b, "bound_by": by, "library_ms": None, "floor_ms": floor_ms(torch, build, grid, threads),
        "counter": counter,
    }


def step_ap(torch, source, target, rcfg):
    """The float64 Ap of the step's covariance after its scan-to-submap
    registration, as `localization.measurement_update` forms it."""
    from locus_tpu_torch import localization
    from locus_tpu_torch.registration.registry import make_registrar

    icp = make_registrar(rcfg)(source, target)
    return localization.compute_ap_point2plane(source.xyz.double(), source.mask, target.normals.double(),
                                               icp.correspondences, icp.corr_mask)


@uncounted
def check_eigh(torch, build, name, Ap, counter):
    """Kernel B8 against its plain version on the step's own Ap (one
    robot's (6, 6) or a batch's): the eigenpairs bit for bit against the
    plain version's batched products (a lone matrix stacked twice: cuBLAS
    takes an unbatched 6x6 product in another order); `max_abs_err` the
    largest difference from the plain version called as the step called
    it. Times: `ms` B8 alone; `plain_ms` the plain version in a CUDA graph,
    as the captured step ran it."""
    from locus_tpu_torch.ops.kernels import eigh as teigh

    got = teigh.eigh6(Ap)
    single = Ap.dim() == 2
    want = teigh.plain_eigh6(torch.stack([Ap, Ap]) if single else Ap)
    if single:
        want = tuple(x[0] for x in want)
    bits = lambda x: x.contiguous().view(torch.int64)
    mismatches = [k for k, a, b in zip(("eigenvalues", "eigenvectors"), got, want) if not torch.equal(bits(a), bits(b))]
    called = teigh.plain_eigh6(Ap)
    err = max(float((a - b).abs().max()) for a, b in zip(got, called))
    ms = device_time_ms(torch, lambda: teigh.eigh6(Ap))
    stream, cuda_graph = torch.cuda.Stream(Ap.device), torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        teigh.plain_eigh6(Ap)
    torch.cuda.synchronize(Ap.device)
    with torch.cuda.graph(cuda_graph, stream=stream):
        teigh.plain_eigh6(Ap)
    plain_ms = device_time_ms(torch, cuda_graph.replay)
    batch = Ap[..., 0, 0].numel()
    grid, threads = teigh.launch_grid(batch)
    # per member 30 rounds: 3 rotations (~18 operations each) and 108
    # FMAs (the row mix of M, the column mixes of M and V: two each for
    # 36 + 36 + 36 entries), an FMA as two; 36 doubles in, 42 out
    b, by = bound_ms(batch * 30 * (3 * 18 + 2 * 108), batch * 78 * 8)
    return not mismatches, {
        "name": name, "route": "cuda", "source": "locus_tpu_torch/csrc/eigh.cu",
        "replaces": "none: the JAX jacobi_eigh is XLA-fused (locus_tpu/utils/linalg.py)",
        "batch": batch, "grid": list(grid), "threads": threads, "mismatches": mismatches,
        "max_abs_err": err, "tolerance": "eigenpairs bit for bit against the plain version's batched products",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None,
        "floor_ms": floor_ms(torch, build, grid, threads), "counter": counter,
    }


def kernel_checks(torch, tnn, tmom, build, cfg, pc, state, suffix, raw=None):
    """B1/B5 and B2 (scan, map) on one robot's inputs, or B4/B6, B3 (scan,
    map) and B3 map at B = 16 on a batch's, all from the reference run's
    state; given the raw sweep, B7 on the step's two GICP calls and B8 on
    the step's Ap."""
    radius = cfg.filtering.normals_radius_scale * state.voxel_leaf
    ok_m, results = check_moments(torch, tmom, build, pc.xyz, radius, suffix if pc.xyz.dim() == 2 else "")
    oks = [ok_m]
    for case in nn_cases(torch, tnn, cfg, pc, state, suffix):
        ok, res = check_nn(torch, tnn, build, *case)
        oks.append(ok), results.append(res)
    for name, source, target, rcfg in gicp_cases(torch, cfg, raw, state, suffix) if raw is not None else ():
        ok, res = check_gicp(torch, build, name, source, target, rcfg, f"gicp_trip{suffix}")
        oks.append(ok), results.append(res)
    if raw is not None:
        _, source, target, rcfg = gicp_cases(torch, cfg, raw, state, suffix)[1]
        ok, res = check_eigh(torch, build, f"eigh6{suffix}", step_ap(torch, source, target, rcfg), f"eigh6{suffix}")
        oks.append(ok), results.append(res)
    return all(oks), results


def gicp_problems(record):
    """B7 runs every disk-path trip: each phase whose GICP keeps the
    normals' disks launches it and runs no plain trip on the card; the
    features phases (adaptive covariances) run the plain trip and no B7.
    The ndt phases run no GICP (not checked)."""
    problems = []
    phases = (("pipeline", "batched") + tuple(PATHS) + ("live", "slam", "husky")
              + tuple(f"batched_{p}" for p in BATCHED_PATHS) + ("sharded", "sharded_batched", "sharded_live"))
    for phase in phases:
        runs = record[phase]["launches"]
        for launches in runs if isinstance(runs, list) else [runs]:
            b7, plain = launches["gicp_trip"], launches["gicp_plain_trips"]
            path = phase.removeprefix("batched_")
            if path == "features" and b7:
                problems.append(f"{phase}: B7 launched on the adaptive-covariance path: {b7}")
            elif path not in ("features", "ndt") and (b7 <= 0 or plain):
                problems.append(f"{phase}: GICP trips on the disk path: B7 {b7}, plain {plain}")
    return problems


def eigh_problems(record):
    """B8 runs every covariance on the card: each phase launches it."""
    phases = (("pipeline", "batched") + tuple(PATHS) + ("live", "slam", "husky")
              + tuple(f"batched_{p}" for p in BATCHED_PATHS) + ("sharded", "sharded_batched", "sharded_live"))
    problems = []
    for phase in phases:
        runs = record[phase]["launches"]
        for launches in runs if isinstance(runs, list) else [runs]:
            if launches.get("eigh6", 0) <= 0:
                problems.append(f"{phase}: no B8 launch: {launches.get('eigh6')}")
    return problems


def run_path(torch, np, runner, cfg, seq, ref_poses, name, dev):
    """One path's PATH_SCANS-scan replay through the kernels, launch counts
    of this run only, and its first poses against its plain reference."""
    from locus_tpu_torch.ops.kernels import read_launches, reset_launches
    from locus_tpu_torch.metrics import ate_rmse

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    poses, outputs, report = runner.run_sequence(seq, cfg, max_scans=PATH_SCANS, device=dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    dur = np.asarray(report.durations)
    window = dur[-RATE_WINDOW:]
    ate = ate_rmse(poses[:, :3, 3], seq.gt_poses[: poses.shape[0], :3, 3], align=False)
    ab = np.abs(poses[:REF_SCANS, :3, 3] - ref_poses[:, :3, 3]).max(axis=1)
    return {
        "phase": name, "scans": int(poses.shape[0]), "captured": report.captured,
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


def run_batched_path(torch, np, runner, pipeline, cfg, seqs, ref_poses, name, dev):
    """One path's batched replay of len(seqs) robots through the kernels,
    launch counts of this run only; each robot also alone through
    make_scan_replay (timed); the first ticks against the plain reference
    (`ref_poses` (REF_SCANS, B, 4, 4))."""
    from locus_tpu_torch.ops.kernels import read_launches, reset_launches
    from locus_tpu_torch.metrics import RateReport, ate_rmse

    robots, ticks = len(seqs), len(seqs[0])
    packed = [runner.pack_sequence(s, cfg, device=dev) for s in seqs]
    init = np.stack([s.gt_poses[0] for s in seqs])
    single_replay = runner.make_scan_replay(cfg)
    single_poses, single_ms = [], []
    for s, p in zip(seqs, packed):
        timing = RateReport()
        st = pipeline.init_state_from_config(cfg, torch.as_tensor(s.gt_poses[0], dtype=torch.float32), device=dev)
        single_poses.append(single_replay(st, p, report=timing)[1][0].cpu().numpy().astype(np.float64))
        single_ms.append(float(np.median(timing.durations[-TICK_WINDOW:]) * 1e3))
    stacked = runner.stack_packed(packed)
    states = pipeline.init_states(cfg, init, device=dev)
    report, outs = RateReport(), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    states, (poses, _, sizes) = runner.make_batched_replay(cfg)(states, stacked, report=report, outputs=outs)
    wall = time.perf_counter() - t0
    launches = read_launches()
    poses = poses.cpu().numpy().astype(np.float64)           # (T, B, 4, 4)
    dur = np.asarray(report.durations)
    window = dur[-TICK_WINDOW:]
    rate = window.size / float(window.sum())
    ates = [ate_rmse(poses[:, b, :3, 3], s.gt_poses[:ticks, :3, 3], align=False) for b, s in enumerate(seqs)]
    vs_single = [float(np.abs(poses[:, b, :3, 3] - single_poses[b][:, :3, 3]).max()) for b in range(robots)]
    ab = np.abs(poses[:REF_SCANS, :, :3, 3] - ref_poses[..., :3, 3]).max(axis=(1, 2))
    loc_its = np.stack([o.loc_iterations.cpu().numpy() for o in outs])        # (T, B)
    return {
        "phase": f"batched_{name}", "robots": robots, "ticks": int(dur.size), "captured": report.captured,
        "single_captured": timing.captured,
        "sequence": ROBOT_SEQUENCE_NAMES[name],
        "ticks_per_s_last16": rate, "robot_scans_per_s_last16": robots * rate,
        "ms_per_tick_p50_last16": float(np.median(window) * 1e3), "ms_per_tick_max_last16": float(window.max() * 1e3),
        "single_ms_per_scan_p50_last16": single_ms,
        "tick_over_single_scan": float(np.median(window) * 1e3 / np.median(single_ms)),
        "first_tick_s": float(dur[0]), "wall_s": wall,
        "ate_m": ates, "max_translation_vs_single_m": vs_single,
        "ab_ticks": REF_SCANS, "ab_max_translation_m": float(ab.max()), "ab_per_tick_m": ab.tolist(),
        "launches": launches, "launches_per_tick": {k: v / dur.size for k, v in launches.items()},
        "loc_iterations_per_tick_max": loc_its.max(axis=1).tolist(),
        "loc_iterations_sum_over_robots": int(loc_its.sum()),
        "keyframes": [int(k) for k in states.stats.keyframe_count.tolist()],
        "final_map_sizes": sizes[-1].tolist(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def batched_path_problems(record, expected):
    """What fails a batched path phase."""
    name, launches, problems = record["phase"], record["launches"], []
    if min(launches[k] for k in expected) <= 0:
        problems.append(f"{name}: the batched path did not launch {expected}: {launches}")
    if "moments_visits_batched" not in expected and launches["moments_visits_batched"]:
        problems.append(f"{name}: kernel B4 launched on the kNN-normals path: {launches}")
    if any(launches[k] for k in SINGLE_PATH):
        problems.append(f"{name}: a single-member kernel launched on a batched path: {launches}")
    ates = record["ate_m"]
    if not all(math.isfinite(a) for a in ates) or max(ates) > ATE_LIMIT_M:
        problems.append(f"{name}: ATE {ates} m exceeds {ATE_LIMIT_M} m")
    if max(record["max_translation_vs_single_m"]) > BATCHED_LIMIT_M:
        problems.append(f"{name}: robots differ from their single replays by {record['max_translation_vs_single_m']} m")
    if record["ab_max_translation_m"] > AB_LIMIT_M:
        problems.append(f"{name}: kernels and plain versions differ by {record['ab_max_translation_m']} m")
    return problems


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
    from locus_tpu_torch.ops.kernels import build, moments as tmom, nn as tnn, read_launches, reset_launches

    record = {}
    dev = torch.device("cuda")
    try:
        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
        record["device"] = {
            "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi_line, "compute_mode": mode,
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

        cfg = cfg_mod.production_config()
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
            ref_poses, _, ref_report, ref_state = runner.run_sequence(
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
        batched_seqs, batched_refs, batched_path_s = {}, {}, {}
        for name in BATCHED_PATHS:
            t0 = time.perf_counter()
            batched_seqs[name] = robot_sequences(dataset, name)
            pcfg = path_config(cfg, name)
            ticks = runner.stack_packed([runner.pack_sequence(s, pcfg, max_scans=REF_SCANS, device=dev)
                                         for s in batched_seqs[name]])
            init = np.stack([s.gt_poses[0] for s in batched_seqs[name]])
            batched_refs[name] = runner.make_batched_replay(pcfg, use_pallas=False)(
                pipeline.init_states(pcfg, init, device=dev), ticks
            )
            batched_path_s[name] = time.perf_counter() - t0
        record["reference"] = {
            "phase": "reference", "scans": REF_SCANS, "seconds": single_s, "data_seconds": data_s,
            # the single reference runs the captured step (the plain versions
            # inside the graph); the other paths and the batched step run eagerly
            "captured": {"single": ref_report.captured} | {name: ref[2].captured for name, ref in path_refs.items()}
            | {"batched": False},
            "batched_ticks": REF_SCANS, "batched_seconds": batched_s, "path_seconds": path_s,
            "batched_path_seconds": batched_path_s,
        }
        emit(record["reference"])

        # 4. kernels at the main paths' shapes, inputs from the reference states
        raw = raw_for_checks(torch, cfg, [seq], REF_SCANS, dev)
        pc = cloud_for_checks(cfg, raw, ref_state.voxel_leaf)
        ok_single, results = kernel_checks(torch, tnn, tmom, build, cfg, pc, ref_state, "", raw=raw)
        rawb = raw_for_checks(torch, cfg, robot_seqs, REF_SCANS, dev)
        pcb = cloud_for_checks(cfg, rawb, ref_states.voxel_leaf)
        ok_batched, batched_results = kernel_checks(torch, tnn, tmom, build, cfg, pcb, ref_states, "_batched",
                                                    raw=rawb)
        results += batched_results
        # B2 map on the voxel-hash operand: a slot is a hash of its voxel,
        # so every chunk spans the window and a tile visits every chunk
        vh_cfg, vh_state = path_config(cfg, "voxel_hash"), path_refs["voxel_hash"][3]
        pcv = scan_for_checks(torch, cfg, [seq], REF_SCANS, vh_state.voxel_leaf, dev)
        _, bt, radius, args, query, target = nn_cases(torch, tnn, vh_cfg, pcv, vh_state, "")[1]
        ok_vh, res_vh = check_nn(torch, tnn, build, VOXEL_HASH_MAP, bt, radius, args, query, target)
        results.append(res_vh)
        # B3 map on the 4 robots' voxel-hash operands, every chunk visited
        bvh_state = batched_refs["voxel_hash"][0]
        pcbv = scan_for_checks(torch, cfg, batched_seqs["voxel_hash"], REF_SCANS, bvh_state.voxel_leaf, dev)
        _, bt, radius, args, query, target = nn_cases(torch, tnn, vh_cfg, pcbv, bvh_state, "_batched")[1]
        ok_bvh, res_bvh = check_nn(torch, tnn, build, BATCHED_VOXEL_HASH_MAP, bt, radius, args, query, target)
        results.append(res_bvh)
        # B2 map on shard 0 of the sharded phase's map (65536 slots), B3 map
        # on a data row's 2 robots at shard 0 of theirs (phases 13-14)
        from locus_tpu_torch.core.cloud import PointCloud
        from locus_tpu_torch.parallel.mesh import Mesh, shard_state

        shard0 = Mesh(1, SHARDED_RANKS, 0, dev, "gloo")
        cap = cfg.mapper.map_capacity
        st = ref_state._replace(map=shard_state(shard0, ref_state.map, cap, at_map_root=True))
        _, bt, radius, args, query, target = nn_cases(torch, tnn, cfg, pc, st, "")[1]
        ok_sh, res_sh = check_nn(torch, tnn, build, "nn_visits_map" + SHARD_SUFFIX, bt, radius, args, query, target)
        results.append(res_sh)
        row = pipeline.stack_states([pipeline.member(ref_states, b) for b in range(ROBOTS // 2)])
        row = row._replace(map=shard_state(shard0, row.map, cap, batched=True, at_map_root=True))
        pcr = PointCloud(*(x[: ROBOTS // 2] for x in pcb))
        _, bt, radius, args, query, target = nn_cases(torch, tnn, cfg, pcr, row, "_batched")[1]
        ok_bsh, res_bsh = check_nn(torch, tnn, build, "nn_visits_batched_map" + SHARD_SUFFIX, bt, radius, args,
                                   query, target)
        results.append(res_bsh)
        record["kernels"] = {
            "phase": "kernels", "checks": results, "map_points": int(ref_state.map.cloud.mask.sum()),
            "voxel_hash_map_points": int(vh_state.map.cloud.mask.sum()),
            "batched_voxel_hash_map_points": bvh_state.map.cloud.mask.sum(-1).tolist(),
            "batched_map_points": ref_states.map.cloud.mask.sum(-1).tolist(),
            "batched_leaves": ref_states.voxel_leaf.tolist(),
        }
        emit(record["kernels"])
        if not (ok_single and ok_batched and ok_vh and ok_bvh and ok_sh and ok_bsh):
            raise RuntimeError("a kernel disagrees with its plain version")

        # 5. pipeline through the kernels, launch counts of this run only
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        poses, outputs, report = runner.run_sequence(seq, cfg, device=dev)
        wall = time.perf_counter() - t0
        launches = read_launches()
        dur = np.asarray(report.durations)
        gt = seq.gt_poses[: poses.shape[0]]
        ate = ate_rmse(poses[:, :3, 3], gt[:, :3, 3], align=False)
        record["pipeline"] = {
            "phase": "pipeline", "scans": int(poses.shape[0]), "captured": report.captured,
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
        if not report.captured:
            raise RuntimeError("the production replay did not run the captured step")
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

        # 6b. compiled: the same scans through the eager step, in this call
        record["compiled"] = run_compiled(torch, np, runner, pipeline, cfg, seq, record["pipeline"], poses, dev)
        emit(record["compiled"])
        problems = compiled_problems(record["compiled"])
        if problems:
            raise RuntimeError("; ".join(problems))

        # 7. batched: 4 robots through make_batched_replay, each also alone
        single_replay = runner.make_scan_replay(cfg)
        single_poses = []
        for s, p in zip(robot_seqs, robot_packed):
            st = pipeline.init_state(cfg, initial_pose=torch.as_tensor(s.gt_poses[0], dtype=torch.float32), device=dev)
            single_report = RateReport()
            single_poses.append(single_replay(st, p, report=single_report)[1][0].cpu().numpy().astype(np.float64))
        packed = runner.stack_packed(robot_packed)
        states = pipeline.init_states(cfg, init_poses, device=dev)
        ticks = RateReport()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        states, (bposes, _, bsizes) = runner.make_batched_replay(cfg)(states, packed, report=ticks)
        wall = time.perf_counter() - t0
        blaunches = read_launches()
        bposes = bposes.cpu().numpy().astype(np.float64)          # (T, B, 4, 4)
        dur = np.asarray(ticks.durations)
        ates = [ate_rmse(bposes[:, b, :3, 3], s.gt_poses[:ROBOT_SCANS, :3, 3], align=False)
                for b, s in enumerate(robot_seqs)]
        vs_single = [float(np.abs(bposes[:, b, :3, 3] - single_poses[b][:, :3, 3]).max()) for b in range(ROBOTS)]
        tick_rate = TICK_WINDOW / float(dur[-TICK_WINDOW:].sum())
        record["batched"] = {
            "phase": "batched", "robots": ROBOTS, "ticks": int(dur.size), "steps": list(ROBOT_STEPS),
            "captured": ticks.captured, "single_captured": single_report.captured,
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
        record["batched_captured"] = run_batched_captured(torch, np, runner, pipeline, cfg, packed, init_poses,
                                                          bposes, dev)
        emit(record["batched_captured"])
        problems = batched_captured_problems(record["batched_captured"], record["batched"])
        if problems:
            raise RuntimeError("; ".join(problems))

        # 8. the other single-card paths through the kernels; every path
        # runs, then any path's failure fails the script
        problems = []
        for name, expected in PATHS.items():
            record[name] = run_path(torch, np, runner, path_config(cfg, name), path_seqs[name],
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
        circuits, served = {}, {}
        for name, azimuth, run in (("live", LIVE_AZIMUTH, serve_live), ("slam", SLAM_AZIMUTH, run_slam)):
            t0 = time.perf_counter()
            circuits[name] = circuit = circuit_sequence(CIRCUIT_SCANS, azimuth)
            data_s = time.perf_counter() - t0
            record[name], served[name] = run(torch, np, scfg, circuit, dev, workdir)
            record[name] |= {
                "azimuth_steps": azimuth, "step_m": CIRCUIT_STEP, "laps": CIRCUIT_LAPS, "seed": CIRCUIT_SEED,
                "backend": LOOP_BACKEND | LOOP_REGISTRATION, "data_seconds": data_s,
            }
            emit(record[name])
        problems = live_problems(record["live"]) + slam_problems(record["slam"])
        if problems:
            raise RuntimeError("; ".join(problems))

        # 11. husky: three merged lidars from a bag through the kernels
        hcfg = cfg_mod.load_yaml(str(ROOT / "configs" / "husky.yaml"))
        record["husky"], _, ref = run_husky(torch, np, hcfg, dev, husky_data(np, workdir))
        pch, hstate, hraw = husky_kernel_inputs(torch, hcfg, ref, dev)
        ok_husky, husky_rows = kernel_checks(torch, tnn, tmom, build, hcfg, pch, hstate, HUSKY_SUFFIX, raw=hraw)
        record["husky"]["kernel_checks"] = husky_rows
        emit(record["husky"])
        problems = husky_problems(record["husky"])
        if not ok_husky:
            problems.append("husky: a kernel disagrees with its plain version at the husky path's inputs")
        if problems:
            raise RuntimeError("; ".join(problems))

        # 12. the batched paths through the kernels; every path runs, then
        # any path's failure fails the script
        problems = []
        for name, expected in BATCHED_PATHS.items():
            ref_poses_b = batched_refs[name][1][0].cpu().numpy().astype(np.float64)
            rec = run_batched_path(torch, np, runner, pipeline, path_config(cfg, name),
                                   batched_seqs[name], ref_poses_b, name, dev)
            record[rec["phase"]] = rec
            emit(rec)
            problems += batched_path_problems(rec, expected)
        if problems:
            raise RuntimeError("; ".join(problems))

        # 13-15. the sharded deployments as ranks on this card; every phase
        # runs, then any phase's failure fails the script
        cap = cfg.mapper.map_capacity
        (workdir / RANK_INPUTS).mkdir(exist_ok=True)
        try:
            record["sharded"] = run_sharded(np, workdir, seq, poses, [o["map_size"] for o in outputs], cfg)
            emit(record["sharded"])
            record["sharded_batched"] = run_sharded_batched(np, workdir, robot_seqs, single_poses)
            emit(record["sharded_batched"])
            record["sharded_live"] = run_sharded_live(np, workdir, circuits["live"], served["live"])
            emit(record["sharded_live"])
        finally:
            shutil.rmtree(workdir / RANK_INPUTS, ignore_errors=True)
        problems = (sharded_problems(record["sharded"], cap) + sharded_batched_problems(record["sharded_batched"], cap)
                    + sharded_live_problems(record["sharded_live"]) + gicp_problems(record)
                    + eigh_problems(record))
        if problems:
            raise RuntimeError("; ".join(problems))

        # 16. the tools, each in a process of its own; every tool runs,
        # then any tool's failure fails the script
        t0 = time.perf_counter()
        record["tools"], tools = run_tools(np, workdir / "tools")
        record["tools"]["seconds"] = time.perf_counter() - t0
        record["tools"]["results"] = {k: v["result"] for k, v in tools.items()}
        problems = tools_problems(tools, poses)
        if problems:
            raise RuntimeError("; ".join(problems))
    except Exception:
        traceback.print_exc()
        emit({"phase": "failed", "completed": list(record)})
        return 1

    # B1/B2 summed over the single paths, live serving and the SLAM replay
    # (the ring-map B2 rows over the paths with a ring map, the voxel-hash
    # row over its own); B5/B6 and B3 at B = 16 lie on no path
    single = ("pipeline",) + tuple(PATHS) + ("live", "slam")
    counts = {k: sum(record[p]["launches"][k] for p in single) for k in SINGLE_PATH}
    counts["nn_visits_map"] -= record["voxel_hash"]["launches"]["nn_visits_map"]
    counts[VOXEL_HASH_MAP] = record["voxel_hash"]["launches"]["nn_visits_map"]
    # B3/B4 summed over the batched replay and the batched paths (the B3
    # map rows split as the B2 ones: ring maps, and the voxel-hash operand)
    batched = ("batched",) + tuple(f"batched_{p}" for p in BATCHED_PATHS)
    counts |= {k: sum(record[p]["launches"][k] for p in batched) for k in BATCHED_PATH}
    counts["nn_visits_batched_map"] -= record["batched_voxel_hash"]["launches"]["nn_visits_batched_map"]
    counts[BATCHED_VOXEL_HASH_MAP] = record["batched_voxel_hash"]["launches"]["nn_visits_batched_map"]
    # B7's trips and the plain trips on the card: the single paths, the
    # batched ones (`_batched`) and husky's (`_husky`), the sharded ranks
    # below; both stages on one row
    counts |= {k: sum(record[p]["launches"][k] for p in single) for k in GICP_ROWS + EIGH_ROWS}
    counts |= {f"{k}_batched": sum(record[p]["launches"][k] for p in batched) for k in GICP_ROWS + EIGH_ROWS}
    # the husky path's launches on its own rows (B1, B2 scan and map)
    husky = record["husky"]["launches"]
    counts |= {f"moments_visits{HUSKY_SUFFIX}": husky["moments_visits"],
               f"nn_visits{HUSKY_SUFFIX}_scan": husky["nn_visits_scan"],
               f"nn_visits{HUSKY_SUFFIX}_map": husky["nn_visits_map"]}
    counts |= {f"{k}{HUSKY_SUFFIX}": husky[k] for k in GICP_ROWS + EIGH_ROWS}
    # the sharded phases, summed over their ranks: B1 and B2 scan on the
    # single rows, B3 scan and B4 on the batched rows, the map 1-NN on the
    # `_shard` rows (one shard's operand)
    for phase, rows, shard_row, suffix in (("sharded", SINGLE_PATH, "nn_visits_map", ""),
                                           ("sharded_live", SINGLE_PATH, "nn_visits_map", ""),
                                           ("sharded_batched", BATCHED_PATH, "nn_visits_batched_map", "_batched")):
        for launches in record[phase]["launches"]:
            for k in rows:
                key = k + SHARD_SUFFIX if k == shard_row else k
                counts[key] = counts.get(key, 0) + launches[k]
            for k in GICP_ROWS + EIGH_ROWS:
                counts[k + suffix] += launches[k]
    summary = [
        {k: v for k, v in r.items() if k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "floor_ms", "trip_ms", "plain_trip_ms")}
        | {"launches": counts.get(r.get("counter", r["name"]), 0)}
        | ({"plain_trips": counts[r["counter"].replace("gicp_trip", "gicp_plain_trips")]}
           if r.get("counter", "").startswith("gicp_trip") else {})
        for r in record["kernels"]["checks"] + record["husky"]["kernel_checks"]
    ]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
