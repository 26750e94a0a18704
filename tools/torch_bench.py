#!/usr/bin/env python3
"""The port's benchmark: bench.py's protocol on locus_tpu_torch.

Replays 48 scans of make_tunnel_sequence(azimuth_steps=1800, step=0.35,
seed=0) at bench.py's production config (4096-point scans, 32768-point raw
sweeps, 3000 points a callback, normals_k 20, a 131072-slot map) through
runner.make_scan_replay: a 16-scan warm run and one untimed full replay,
then 5 timed full replays, each from a fresh state and fenced by a device
synchronisation before and after. The headline is their median.

Prints ONE JSON line with bench.py's fields: metric, value (scans/s),
unit, vs_baseline (value / 10, the reference's 10 Hz real-time rate),
estimator, best, mad, rates, ate_m, scans, map_capacity, scan_capacity;
`device` and `power_limit_w` (nvidia-smi's) take the place of `platform`.
bench.py's garage side-measurement (a replay of the reference's garage
PCD) is left out: that file lies outside the repository.

    python tools/torch_bench.py [--device cpu] [--reps N] [--json out.json]

Runs on the CUDA device unless --device cpu, which selects bench.py's CI
fallback config (12 scans of 512 azimuth steps); --reps shrinks the timed
runs (for the tests). Imports neither JAX nor the JAX package.
"""
import argparse
import json
import time

import _torch_tool
import numpy as np


def bench(cfg, num_scans: int, warmup_scans: int, azimuth: int, reps: int, dev) -> dict:
    """bench.py's protocol at `cfg` on `dev`: the result line's fields."""
    import torch

    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    seq = make_tunnel_sequence(num_scans=num_scans, azimuth_steps=azimuth, step=0.35, seed=0)
    replay = runner.make_scan_replay(cfg)
    pose0 = torch.as_tensor(seq.gt_poses[0], dtype=torch.float32)

    def fresh_state():
        return pipeline.init_state(cfg, initial_pose=pose0, device=dev)

    packed_warm = runner.pack_sequence(seq, cfg, max_scans=warmup_scans, device=dev)
    packed_full = runner.pack_sequence(seq, cfg, max_scans=num_scans, device=dev)
    replay(fresh_state(), packed_warm)                # kernel builds, allocator warm-up
    replay(fresh_state(), packed_full)                # one untimed full-length run
    rates = []
    _torch_tool.reset_launches()                      # the timed replays' launches
    for _ in range(reps):
        st = fresh_state()
        _torch_tool.sync(torch, dev)                  # fence: the state is on the device
        t0 = time.perf_counter()
        _, (poses, _, _) = replay(st, packed_full)
        _torch_tool.sync(torch, dev)                  # fence: every scan done
        poses = poses.cpu().numpy()
        rates.append(num_scans / (time.perf_counter() - t0))
    launches = _torch_tool.launch_counts()
    value = float(np.median(rates))
    gt = seq.gt_poses[:num_scans, :3, 3]
    ate = float(np.sqrt(np.mean(np.sum((poses[:, :3, 3] - gt) ** 2, axis=1))))
    return {
        "metric": "scans_per_sec_per_chip",
        "value": value,
        "unit": "scans/s",
        "vs_baseline": value / 10.0,
        "estimator": f"median_of_{reps}",
        "best": float(np.max(rates)),
        "mad": float(np.median(np.abs(np.asarray(rates) - value))),
        "rates": sorted(float(r) for r in rates),
        "ate_m": ate,
        "scans": num_scans,
        "map_capacity": cfg.mapper.map_capacity,
        "scan_capacity": cfg.scan_capacity,
        "launches": launches,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    _torch_tool.add_device_arg(ap)
    ap.add_argument("--reps", type=int, default=5, help="timed full replays (the median is the headline)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    dev = _torch_tool.device(args.device)
    if dev.type == "cuda":
        cfg, sizes = _torch_tool.production_config(), (48, 16, 1800)
    else:  # bench.py's CI fallback
        cfg, sizes = _torch_tool.fallback_config(), (12, 4, 512)
    result = bench(cfg, *sizes, args.reps, dev) | _torch_tool.device_record(dev)
    print(json.dumps(result), flush=True)
    _torch_tool.write_json(args.json, result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
