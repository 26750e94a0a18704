#!/usr/bin/env python3
"""Experiment: the per-scan cost of the benchmark's replay under config
ablations (tools/exp_gap.py on locus_tpu_torch). Not part of the
benchmark.

Replays the benchmark's workload (tools/torch_bench.py: bench.py's
production config, 48 scans of make_tunnel_sequence(azimuth_steps=1800,
step=0.35, seed=0)) from a fresh state under each variant of
tools/exp_gap.py:105-144 and reports each one's best scans/s and ms a
scan over the timed replays, beside every rep's rate and the B1/B2
launches a scan. Each variant gets one untimed replay, the default
config's first: it gives the per-scan iteration counts of both
registration stages, the keyframe and MSW-refresh scans
(exp_gap.py:94-103). Then the timed replays run round by round over the
variants, and every one's poses equal its variant's untimed replay's bit
for bit.

The replay is `runner.make_scan_replay`, whose body is exp_gap.py's: the
sensor windows pushed into the fusion buffers, then `pipeline.step` with
the scan's sequence number.

Prints ONE JSON line with exp_gap.py's keys (odom_iters, loc_iters,
kf_scans, msw_scans, mean_odom_iters, mean_loc_iters, and a row of
scans_per_s and ms_per_scan for each variant, best of the reps) and, beside
them, every rep's rate and the launches (each row), the default config's
poses from its untimed replay (`default_poses`), and the card's name and
power limit. `--scans N` replays only the first N scans of the sequence.

    python tools/torch_exp_gap.py [--device cpu] [--scans N] [--reps N] [--json out.json]

Runs on the CUDA device unless --device cpu, which selects bench.py's CI
fallback config at 512 azimuth steps. Imports neither JAX nor the JAX
package.
"""
import argparse
import json

import _torch_tool
import numpy as np

SEQ_SCANS = 48
# tools/exp_gap.py:105-144, as `_torch_tool.ablated` arguments
VARIANTS = {
    "default": {},
    "no_keyframes": dict(keyframes=False, msw=False),
    "iter_cap_8": dict(odom_iterations=8, loc_iterations=8),
    "iter_cap_4": dict(odom_iterations=4, loc_iterations=4),
    "inner_2": dict(inner_iterations=2),
    "no_cov": dict(icp_covariance=False),
    "no_adaptive": dict(adaptive_leaf=False),
}


def run(cfg0, scans: int, azimuth: int, reps: int, dev) -> dict:
    import torch

    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    seq = make_tunnel_sequence(num_scans=SEQ_SCANS, azimuth_steps=azimuth, step=0.35, seed=0)
    packed = runner.pack_sequence(seq, cfg0, max_scans=scans, device=dev)
    pose0 = torch.as_tensor(seq.gt_poses[0], dtype=torch.float32)
    runs = {}
    for name, change in VARIANTS.items():
        cfg = _torch_tool.ablated(cfg0, **change)
        replay = runner.make_scan_replay(cfg)
        runs[name] = (scans, lambda cfg=cfg: pipeline.init_state(cfg, initial_pose=pose0, device=dev),
                      lambda st, outs, replay=replay: replay(st, packed, outputs=outs)[1][0])
    timed = _torch_tool.interleaved(runs, {name: reps for name in runs}, dev)
    # the default config's iteration counts, from its untimed replay
    outs = timed["default"]["outputs"]
    odom = [int(o.odom_iterations) for o in outs]
    loc = [int(o.loc_iterations) for o in outs]
    report = {
        "odom_iters": odom, "loc_iters": loc,
        "kf_scans": sum(int(o.keyframe_inserted) for o in outs),
        "msw_scans": sum(int(o.msw_refreshed) for o in outs),
        "mean_odom_iters": float(np.mean(odom)), "mean_loc_iters": float(np.mean(loc)),
    }
    rows = {name: _torch_tool.rate_row(timed[name], scans) for name in runs}
    return report | rows | {"scans": scans, "azimuth_steps": azimuth, "reps": reps,
                            "default_poses": timed["default"]["poses"].tolist()}

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _torch_tool.add_experiment_args(ap, scans=SEQ_SCANS, reps=3)
    args = ap.parse_args()
    dev = _torch_tool.device(args.device)
    cfg, azimuth = _torch_tool.experiment_setup(dev)
    result = run(cfg, args.scans, azimuth, args.reps, dev) | _torch_tool.device_record(dev)
    print(json.dumps(result), flush=True)
    _torch_tool.write_json(args.json, result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
