#!/usr/bin/env python3
"""Per-stage profile of the PyTorch port's pipeline step on a CUDA card.

Replays the production tunnel protocol (bench.py's config, 48 scans of
make_tunnel_sequence(azimuth_steps=1800, step=0.35, seed=0)) through
locus_tpu_torch, then traces the last scans with torch.profiler and
buckets host and device time by the step's stage scopes (stage_pre,
stage_prior, stage_s2s, stage_ann, stage_s2m, stage_kf, stage_msw).
It reports, per scan: host time and device (kernel) time of each stage,
CUDA kernel launches, host synchronisations and the ops that issue them,
the device's idle share of
the traced window (kernel time over wall time; the profiler slows the
host, so the same scans are also timed untraced), and the top kernels
and host ops.

    python tools/torch_stage_profile.py [--scans 48] [--traced 8]
        [--robots 1] [--out chiprun_out/stage_profile.json]

With --config ndt|features|voxel_hash it profiles another single-card path
(chip_smoke.path_config, on chip_smoke.path_sequence's replay). With
--config live it profiles live serving: LiveSession.process_scan (the
step with one upload and one fetch a scan, IMU and odometry fed ahead)
on the first scans of chip_smoke.py's live circuit (900 azimuth steps,
the serving config); a scan is then timed up to the pose on the host.

With --robots B > 1 it profiles the batched step instead: B robots, each
on its own tunnel (chip_smoke.py's batched phase: steps 0.30, 0.35, ...,
seeds 0, 1, ...), one batched step per tick; every "per scan" figure is
then per tick of all B robots.

Imports neither JAX nor locus_tpu; needs a CUDA device.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("stage_pre", "stage_prior", "stage_s2s", "stage_ann", "stage_s2m", "stage_kf", "stage_msw")
SYNC_OPS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _dev_total(evt):
    return getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0.0))


def _self_dev(evt):
    return getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0))


def _wait_sites(events, waits, cuda, n):
    """Per scan, how often each op waits on the device: each event named
    in `waits` goes to the innermost host op whose interval holds it
    (e.g. aten::copy_ for a host-to-device copy of a Python constant,
    aten::_local_scalar_dense for a read of a device scalar)."""
    evs = sorted(
        (e for e in events if e.device_type != cuda),
        key=lambda e: (e.time_range.start, -e.time_range.end),
    )
    sites, open_ops = {}, []
    for e in evs:
        while open_ops and open_ops[-1].time_range.end < e.time_range.start:
            open_ops.pop()
        if e.name in waits:
            key = f"{e.name} <- {open_ops[-1].name if open_ops else 'no op'}"
            sites[key] = sites.get(key, 0) + 1 / n
        elif e.name.startswith("aten::"):
            open_ops.append(e)
    return sites


def live_steps(torch, num_scans, dev):
    """step(state, i) serving scan i of chip_smoke.py's live circuit
    through one LiveSession: the session's state is set to `state` first
    (None: the state it holds), the scan's IMU and odometry samples are
    fed, and process_scan returns the pose on the host. Returns (step,
    the serving config)."""
    import numpy as np

    from chip_smoke import LIVE_AZIMUTH, circuit_sequence, production_config, sensor_feeds, serving_config
    from locus_tpu_torch import config as cfg_mod
    from locus_tpu_torch.live import LiveSession

    cfg = serving_config(production_config(cfg_mod))
    seq = circuit_sequence(num_scans, LIVE_AZIMUTH)
    feeds = sensor_feeds(np, seq)
    sess = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0], device=dev)

    def step(state, i):
        if state is not None:
            sess.state = state
        (i0, i1), (o0, o1) = feeds[i]
        for k in range(i0, i1):
            sess.feed_imu(seq.imu_stamps[k], seq.imu_quats[k])
        for k in range(o0, o1):
            sess.feed_odom(seq.odom_stamps[k], seq.odom_poses[k])
        _, out = sess.process_scan(float(seq.stamps[i]), seq.scans[i], seq.scan_valid[i])
        return sess.state, out

    return step, cfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=48)
    ap.add_argument("--traced", type=int, default=8, help="scans traced at the end of the replay")
    ap.add_argument("--robots", type=int, default=1, help="robots of the batched step (1: the single step)")
    ap.add_argument("--config", choices=("gicp", "ndt", "features", "voxel_hash", "live"), default="gicp",
                    help="the single-card path (the batched step runs gicp only)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "stage_profile.json"))
    args = ap.parse_args()
    if args.robots > 1 and args.config != "gicp":
        ap.error("the batched step runs the gicp path only (ROADMAP A15b)")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_stage_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import path_config, path_sequence, production_config
    from locus_tpu_torch import config as cfg_mod, pipeline, runner
    from locus_tpu_torch.io import dataset
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    dev = torch.device("cuda")
    if args.config == "live":
        step, cfg = live_steps(torch, args.scans, dev)
    else:
        cfg = path_config(production_config(cfg_mod), args.config)
    if args.config == "live":
        state = None
        inputs = list(range(args.scans))
    elif args.robots == 1:
        seq = path_sequence(
            dataset, args.config,
            make_tunnel_sequence(num_scans=args.scans, azimuth_steps=1800, step=0.35, seed=0), num_scans=args.scans,
        )
        state = pipeline.init_state_from_config(
            cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device=dev
        )
        inputs = [runner.scan_inputs(seq, i, cfg, dev) for i in range(args.scans)]
    else:
        seqs = [make_tunnel_sequence(num_scans=args.scans, azimuth_steps=1800, step=0.30 + 0.05 * b, seed=b)
                for b in range(args.robots)]
        state = pipeline.init_states(cfg, [s.gt_poses[0] for s in seqs], device=dev)
        inputs = [
            tuple(torch.stack(x) for x in zip(*(runner.scan_inputs(s, i, cfg, dev) for s in seqs)))
            for i in range(args.scans)
        ]
    if args.config != "live":
        def step(state, i):
            return runner.replay_step(state, *inputs[i], cfg=cfg)

    first = args.scans - args.traced
    for i in range(first):
        state, _ = step(state, i)
    torch.cuda.synchronize()

    # untraced: the same scans from the same state, without the profiler
    # (the step does not modify its input state, so `state` stays at scan
    # `first` for the traced pass)
    t0 = time.perf_counter()
    st = state
    for i in range(first, args.scans):
        st, _ = step(st, i)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0

    iters = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, args.scans):
            state, out = step(state, i)
            iters.append((torch.as_tensor(out.odom_iterations).tolist(), torch.as_tensor(out.loc_iterations).tolist()))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    n = args.traced
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # A stage scope appears twice: as a host range (host time, and the
    # device time of the kernels it launched) and as a device-side span.
    host = {e.key: e for e in events if e.device_type != cuda}
    span = {e.key: e for e in events if e.device_type == cuda and e.key in STAGES}
    kernels = [e for e in events if e.device_type == cuda and e.key not in STAGES and _self_dev(e) > 0]
    busy_us = sum(_self_dev(e) for e in kernels)
    stages = {
        s: {
            "host_ms_per_scan": host[s].cpu_time_total / 1e3 / n,
            "kernel_ms_per_scan": _dev_total(host[s]) / 1e3 / n,
            "device_span_ms_per_scan": _self_dev(span[s]) / 1e3 / n if s in span else None,
        }
        for s in STAGES if s in host
    }
    launches = sum(host[k].count for k in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel") if k in host)
    syncs = {k: host[k].count / n for k in SYNC_OPS + ("cudaMemcpyAsync",) if k in host}
    sites = _wait_sites(prof.events(), SYNC_OPS + ("cudaMemcpyAsync",), cuda, n)
    result = {
        "device": torch.cuda.get_device_name(0),
        "robots": args.robots,
        "config": args.config,
        "traced_scans": n,
        "untraced_wall_ms_per_scan": untraced_s * 1e3 / n,
        "wall_ms_per_scan": wall_s * 1e3 / n,
        "device_busy_ms_per_scan": busy_us / 1e3 / n,
        "device_idle_share_traced": 1.0 - busy_us / 1e6 / wall_s,
        # kernel time does not depend on the host's pace: over the untraced
        # wall time it gives the idle share of a normal run
        "device_idle_share_untraced": 1.0 - busy_us / 1e6 / untraced_s,
        "kernel_launches_per_scan": launches / n,
        "host_syncs_per_scan": syncs,
        "host_sync_sites_per_scan": sorted(sites.items(), key=lambda kv: -kv[1])[:20],
        "gicp_iterations_odom_loc": iters,
        "stages": stages,
        "top_kernels_ms_per_scan": sorted(
            ((e.key[:80], _self_dev(e) / 1e3 / n, e.count / n) for e in kernels), key=lambda x: -x[1]
        )[:15],
        "top_host_ops_ms_per_scan": sorted(
            ((e.key[:80], e.self_cpu_time_total / 1e3 / n, e.count / n) for e in host.values()), key=lambda x: -x[1]
        )[:20],
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in (
        "device", "robots", "config", "untraced_wall_ms_per_scan", "wall_ms_per_scan", "device_busy_ms_per_scan", "device_idle_share_untraced",
        "kernel_launches_per_scan", "host_syncs_per_scan", "stages")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
