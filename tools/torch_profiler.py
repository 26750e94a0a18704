#!/usr/bin/env python3
"""Replay profiler of the port (tools/profiler.py on locus_tpu_torch, the
reference's scripts/profiler.py analog): replays a sequence through
runner.run_sequence, each scan timed up to a device synchronisation, and
prints the rate, the latency percentiles and the replay's summary (ATE,
keyframes, final map size, mean points a scan).

    python tools/torch_profiler.py [--scans 24] [--seq path.npz] [--device cpu] [--json out.json]

The default sequence is make_tunnel_sequence(num_scans, azimuth_steps=900)
at tools/profiler.py's config (4096-point scans, 16384-point raw sweeps, a
65536-slot map). Runs on the CUDA device unless --device cpu. Imports
neither JAX nor the JAX package.
"""
import argparse
import json

import _torch_tool
import numpy as np


def profiler_config():
    """tools/profiler.py's config."""
    from locus_tpu_torch.config import LocusConfig, MapperConfig

    return LocusConfig(scan_capacity=4096, raw_scan_capacity=16384, points_to_process_in_callback=3000,
                       mapper=MapperConfig(map_capacity=1 << 16, keyframe_capacity=4096))


def profile(cfg, seq, max_scans: int, dev) -> dict:
    """The rate report's summary of one replay (count, mean, p50, p95, max
    in s, rate in Hz) with p90/p99 and the replay's summary."""
    from locus_tpu_torch.metrics import ate_rmse
    from locus_tpu_torch.runner import run_sequence

    poses, outputs, report = run_sequence(seq, cfg, max_scans=max_scans, device=dev)
    summary = report.summary()
    d = np.asarray(report.durations)
    summary |= {"p90_s": float(np.percentile(d, 90)), "p99_s": float(np.percentile(d, 99))}
    gt = seq.gt_poses[: poses.shape[0], :3, 3]
    summary["ate_m"] = ate_rmse(poses[:, :3, 3], gt, align=False)
    summary["keyframes"] = sum(o["keyframe_inserted"] for o in outputs)
    summary["final_map_size"] = outputs[-1]["map_size"] if outputs else 0
    summary["mean_points"] = float(np.mean([o["num_points"] for o in outputs]))
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=24)
    ap.add_argument("--seq", default=None)
    _torch_tool.add_device_arg(ap)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    from locus_tpu_torch.io.dataset import Sequence, make_tunnel_sequence

    dev = _torch_tool.device(args.device)
    seq = Sequence.load(args.seq) if args.seq else make_tunnel_sequence(num_scans=args.scans, azimuth_steps=900)
    _torch_tool.reset_launches()
    summary = profile(profiler_config(), seq, args.scans, dev) | _torch_tool.device_record(dev)
    summary["launches"] = _torch_tool.launch_counts()
    print(json.dumps(summary, indent=2), flush=True)
    _torch_tool.write_json(args.json, summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
