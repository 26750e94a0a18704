"""What the port's command-line tools share: the device that --device
names, the card's name and power limit for their JSON, and bench.py's
production config and its fallback. Imports neither JAX nor the JAX
package."""
import json
import subprocess
import sys
from pathlib import Path

import _pathsetup  # noqa: F401

TOOLS = Path(__file__).resolve().parent


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; without a card the tool fails unless --device cpu)")


def device(arg):
    """The torch device of --device: None is the CUDA device, and with no
    card `ops.dispatch.resolve_device` raises (a tool never falls back to
    the CPU by itself)."""
    from locus_tpu_torch.ops.dispatch import resolve_device

    return resolve_device(arg)


def device_record(dev) -> dict:
    """{"device", "power_limit_w", "captured"} of `dev`: on a card,
    nvidia-smi's name and power limit (W); on the CPU "cpu" and None.
    "captured": how many steps this process has run as CUDA graphs
    (`ops.graph.CapturedStep`), 0 where every step ran eagerly."""
    from locus_tpu_torch.ops import graph

    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None, "captured": graph.captures}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in line.rsplit(",", 1))
    return {"device": name, "power_limit_w": float(power.split()[0]), "captured": graph.captures}


def sync(torch, dev) -> None:
    """Wait for the card's queue (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def production_config(map_capacity: int = 1 << 17, scan_capacity: int = 4096):
    """bench.py:38-48 (`config.production_config`): 4096-point scans,
    32768-point raw sweeps, 3000 points a callback, normals_k 20, a
    131072-slot map of 0.15 m leaf; the two capacities may be set."""
    import dataclasses

    from locus_tpu_torch.config import production_config as production

    cfg = production()
    return cfg.replace(scan_capacity=scan_capacity,
                       mapper=dataclasses.replace(cfg.mapper, map_capacity=map_capacity))


def fallback_config():
    """bench.py:49-59's CI fallback: 1024-point scans, 8192-point raw
    sweeps, a 16384-slot map."""
    from locus_tpu_torch.config import FilterConfig, LocusConfig, MapperConfig

    return LocusConfig(
        scan_capacity=1024, raw_scan_capacity=8192, points_to_process_in_callback=800,
        filtering=FilterConfig(normals_k=12),
        mapper=MapperConfig(map_capacity=1 << 14, keyframe_capacity=1024, map_voxel_leaf=0.15),
    )


def write_json(path, record) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(record, f, indent=1)


def reset_launches() -> None:
    """Set the kernels' launch counters of this process to 0: a tool calls
    it just before its main run, and `launch_counts` just after."""
    from locus_tpu_torch.ops.kernels import reset_launches as reset

    reset()


def launch_counts() -> dict:
    """The kernels' launch counters of this process, by chip_smoke.py's row
    names (`ops.kernels.read_launches`)."""
    from locus_tpu_torch.ops.kernels import read_launches

    return read_launches()


def launch_ranks(args: list, world: int, workdir, timeout_s: float) -> dict:
    """tools/torch_dist_smoke.py with `args` as `world` local ranks
    (parallel.distributed.spawn_ranks, a deadline for all of them): rank
    0's record, every rank's under "ranks". A rank that fails raises."""
    from locus_tpu_torch.parallel.distributed import spawn_ranks

    cmd = [sys.executable, str(TOOLS / "torch_dist_smoke.py"), *map(str, args), "--timeout", str(timeout_s)]
    results = spawn_ranks(cmd, world, workdir, timeout_s)
    failed = [f"rank {r} exited {rc}: {err[-2000:]}" for r, (rc, _, err) in enumerate(results) if rc != 0]
    if failed:
        raise RuntimeError(f"{world} ranks: " + "; ".join(failed))
    return json.loads(results[0][1].strip().splitlines()[-1])


def rank_config(profile: str, map_capacity=None, mode: str = "pipeline"):
    """The config tools/torch_dist_smoke.py's ranks run for `profile`."""
    import argparse

    if str(TOOLS) not in sys.path:
        sys.path.append(str(TOOLS))
    import torch_dist_smoke

    return torch_dist_smoke.config(argparse.Namespace(profile=profile, structure=None, map_capacity=map_capacity,
                                                      msw_box=None, mode=mode))


# -- the replay-level experiments (tools/torch_exp_*.py) ----------------------

# B1 and B2 on the single-robot step: the launches a row reports per scan.
SINGLE_PATH = ("moments_visits", "nn_visits_scan", "nn_visits_map")


def add_experiment_args(ap, scans: int, reps: int) -> None:
    """--device, --scans, --reps and --json of an experiment whose sequence
    has `scans` scans (--scans replays only the first ones)."""
    add_device_arg(ap)
    ap.add_argument("--scans", type=int, default=scans, choices=range(1, scans + 1), metavar="N",
                    help=f"replay only the first N of the sequence's {scans} scans")
    ap.add_argument("--reps", type=int, default=reps, help=f"timed replays of each variant (default {reps})")
    ap.add_argument("--json", default=None)


def experiment_setup(dev):
    """(config, azimuth steps of the tunnel) of the experiments: on the card
    bench.py's production config at 1800 steps, on the CPU its CI fallback
    at 512."""
    if dev.type == "cuda":
        return production_config(), 1800
    return fallback_config(), 512


def ablated(cfg, keyframes=None, msw=None, icp_covariance=None, odom_iterations=None, loc_iterations=None,
            inner_iterations=None, adaptive_leaf=None, fusion_mode=None):
    """`cfg` with the JAX experiments' `dc.replace` chains: each argument
    that is not None sets one field (keyframes b_add_keyframes_enabled, msw
    mapper.b_enable_msw, icp_covariance localization.compute_icp_covariance,
    odom_iterations odometry.iterations, loc_iterations
    localization.registration.iterations, inner_iterations both stages'
    inner_iterations, adaptive_leaf b_adaptive_input_voxelization,
    fusion_mode fusion.data_integration_mode)."""
    from dataclasses import replace

    def some(**kw):
        return {k: v for k, v in kw.items() if v is not None}

    top = some(b_add_keyframes_enabled=keyframes, b_adaptive_input_voxelization=adaptive_leaf)
    odom = some(iterations=odom_iterations, inner_iterations=inner_iterations)
    loc = some(iterations=loc_iterations, inner_iterations=inner_iterations)
    if msw is not None:
        top["mapper"] = replace(cfg.mapper, b_enable_msw=msw)
    if fusion_mode is not None:
        top["fusion"] = replace(cfg.fusion, data_integration_mode=fusion_mode)
    if odom:
        top["odometry"] = replace(cfg.odometry, **odom)
    if loc or icp_covariance is not None:
        registration = replace(cfg.localization.registration, **loc)
        top["localization"] = replace(cfg.localization, registration=registration,
                                      **some(compute_icp_covariance=icp_covariance))
    return cfg.replace(**top)


def copy_state(state):
    """A clone of every tensor of a (nested) NamedTuple state: the JAX
    tools' `jnp.array(x, copy=True)` of every leaf. A run that starts from a
    copy leaves the original as it was."""
    import torch

    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple):
        parts = [copy_state(p) for p in state]
        return type(state)(*parts) if hasattr(state, "_fields") else tuple(parts)
    return state


def window(packed, lo: int, hi: int) -> dict:
    """Scans lo..hi-1 of a packed sequence (the JAX tools' `sub`)."""
    return {k: v[lo:hi] for k, v in packed.items()}


def make_replay(cfg, with_seq: bool = True, with_sensors: bool = True):
    """The replay the experiments time, replay(state, packed, outputs=None)
    -> (state, (poses, cond, map sizes)): `runner.make_scan_replay(cfg)`.
    With a switch off it is tools/exp_gap2.py:44-64's body with that part
    left out: with_seq False steps without the scan's sequence number (no
    drop-rate statistics), with_sensors False pushes no IMU or odometry
    window into the fusion buffers."""
    import torch

    from locus_tpu_torch import fusion, pipeline, runner

    if with_seq and with_sensors:
        return runner.make_scan_replay(cfg)

    def replay(state, packed, outputs=None):
        poses, conds, sizes = [], [], []
        for i in range(packed["scan_xyz"].shape[0]):
            xyz, mask, stamp, imu_s, imu_q, odom_s, odom_p, seq_id = (packed[k][i] for k in runner.PACKED_KEYS)
            if with_sensors:
                fuse = fusion.push_odom_batch(fusion.push_imu_batch(state.fuse, imu_s, imu_q), odom_s, odom_p)
                state = state._replace(fuse=fuse)
            state, out = pipeline.step(state, runner.raw_cloud(xyz, mask), stamp, cfg,
                                       seq=seq_id if with_seq else None)
            if outputs is not None:
                outputs.append(out)
            poses.append(out.pose)
            conds.append(out.condition_number)
            sizes.append(out.map_size)
        return state, (torch.stack(poses), torch.stack(conds), torch.stack(sizes))

    return replay


def interleaved(runs: dict, reps: dict, dev) -> dict:
    """Replay each run of `runs` ({name: (scans, start, go)}: start() builds
    its starting state, go(state, outputs) replays it, appending each
    StepOutput to the `outputs` list, and returns the (T, 4, 4) poses) once
    untimed, in order (the warm-up: extension load, allocator), then
    `reps[name]` times timed, round by round: every run once a round, in
    order, so that drift in the host's pace hits all alike. The launch
    counters are set to 0 just before each timed replay and read just
    after. Every timed replay's poses must equal its run's untimed replay
    bit for bit (RuntimeError otherwise): a replay that started from a
    state another one changed would not. Returns {name: {"outputs": the
    untimed replay's StepOutputs, "poses": its poses, "rates": scans/s of
    every timed rep, "launches": the last rep's counts}}."""
    import time

    import numpy as np
    import torch

    res = {}
    for name, (_, start, go) in runs.items():
        outs = []
        res[name] = {"outputs": outs, "poses": go(start(), outs).cpu().numpy(), "rates": []}
    for r in range(max(reps.values())):
        for name, (scans, start, go) in runs.items():
            if r >= reps[name]:
                continue
            state = start()
            sync(torch, dev)                      # fence: the state is on the device
            reset_launches()
            t0 = time.perf_counter()
            poses = go(state, None).cpu().numpy()  # fence: every scan's pose on the host
            res[name]["rates"].append(scans / (time.perf_counter() - t0))
            res[name]["launches"] = launch_counts()
            if not np.array_equal(poses, res[name]["poses"]):
                gap = float(np.abs(poses - res[name]["poses"]).max())
                raise RuntimeError(f"{name}: timed rep {r} left its untimed replay's poses (max gap {gap})")
    return res


def rate_row(timed: dict, scans: int) -> dict:
    """A variant's row: the best rep's scans/s and ms a scan (the JAX
    tools' best of reps), every rep's rate, and the last rep's launches,
    whole and a scan (B1/B2)."""
    best = max(timed["rates"])
    return {
        "scans_per_s": best, "ms_per_scan": 1000.0 / best, "rates": timed["rates"],
        "launches": timed["launches"],
        "launches_per_scan": {k: timed["launches"][k] / scans for k in SINGLE_PATH},
    }
