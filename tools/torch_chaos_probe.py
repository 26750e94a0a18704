#!/usr/bin/env python3
"""How far a replay's poses move when its scans move by far less than the
sensor noise, in the JAX package and in the port, on the CPU.

It replays the first `--scans` scans of tests/test_slam_integration.py's
loop sequence (`loop_sequence(num_scans=36)`: 0.87 m and 10 degrees a
scan, pure lidar odometry, tests/test_torch_slam.py's config) `--runs`
times: run 0 on the scans as they are, run k on the scans plus Gaussian
noise of `--scale` m drawn with seed k. Each run goes through the JAX
package's XLA path and the port's plain path. One JSON line: each run's
per-scan distance from ground truth in both packages. A replay whose
poses move by decimetres under 1e-5 m of noise is chaotic there, and a
port-against-JAX difference of that size is rounding, not a fault.

    JAX_PLATFORMS=cpu python tools/torch_chaos_probe.py [--scale 1e-5] [--runs 5] [--scans 6]
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1e-5)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import numpy as np
    import torch

    from locus_tpu.runner import run_sequence as jax_run
    from locus_tpu_torch.convert import config_from_dict
    from locus_tpu_torch.runner import run_sequence as port_run
    from tests.test_slam_integration import loop_sequence
    from tests.test_torch_slam import _cfg, _tseq

    torch.set_num_threads(args.threads)
    base = loop_sequence(num_scans=36)
    jcfg = _cfg()
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    gt = base.gt_poses[: args.scans, :3, 3]
    runs = []
    for k in range(args.runs):
        noise = np.random.default_rng(k).normal(scale=args.scale, size=base.scans.shape) if k else 0.0
        seq = dataclasses.replace(base, scans=(base.scans + noise).astype(np.float32))
        jp, _, _ = jax_run(seq, jcfg, max_scans=args.scans)
        tp, _, _ = port_run(_tseq(seq), tcfg, max_scans=args.scans, device="cpu")
        runs.append({
            "seed": k if k else None,
            "jax_error_m": np.linalg.norm(jp[:, :3, 3] - gt, axis=1).tolist(),
            "port_error_m": np.linalg.norm(tp[:, :3, 3] - gt, axis=1).tolist(),
        })
    print(json.dumps({"sequence": "loop_sequence(num_scans=36)", "scale_m": args.scale, "scans": args.scans,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
