#!/usr/bin/env python3
"""Experiment: replay-level config ablations to attribute the per-scan
cost (tools/exp_ablate.py on locus_tpu_torch). Not part of the
benchmark.

bench.py's production config on 48 scans of
make_tunnel_sequence(azimuth_steps=1800, step=0.35, seed=0). Each variant
of tools/exp_ablate.py:34-55 replays scans 0-32 from a fresh state (the
warm state, untimed), then replays scans 16-48 from a copy of that state,
once untimed, then timed (`runner.make_scan_replay`, as the JAX tool);
the best rep's scans/s is its result, and every timed rep's poses equal
the untimed replay's bit for bit. NOTE (exp_ablate.py:68-74):
the warm window (0-32) overlaps the timed window (16-48), so the timed
replay re-processes scans 16-31 against a state that already saw them
(stamps go backward once, dt clamps) - not a true steady state, but the
distortion is identical across variants, which is all this A/B ablation
needs. `--scans N` cuts the windows to the sequence's first N scans in the same
proportions: warm 0..2N/3, timed N/3..N.

Prints ONE JSON line with exp_ablate.py's keys (each variant's best
scans/s) and, beside them, `rows` (each variant's every rep, ms a scan
and B1/B2 launches a scan), the base config's poses over its warm window
(`default_poses`), and the card's name and power limit.

    python tools/torch_exp_ablate.py [--device cpu] [--scans N] [--reps N] [--json out.json]

Runs on the CUDA device unless --device cpu, which selects bench.py's CI
fallback config at 512 azimuth steps. Imports neither JAX nor the JAX
package.
"""
import argparse
import json

import _torch_tool

SEQ_SCANS = 48
# tools/exp_ablate.py:34-55, as `_torch_tool.ablated` arguments
VARIANTS = {
    "base": {},
    "no_kf_msw": dict(keyframes=False, msw=False),
    "no_cov": dict(icp_covariance=False),
    "s2s_0iter": dict(odom_iterations=0),
    "s2m_0iter": dict(loc_iterations=0),
    "no_adapt": dict(adaptive_leaf=False),
}


def run(base, scans: int, azimuth: int, reps: int, dev) -> dict:
    import torch

    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    warm_hi, lo = 2 * scans // 3, scans // 3
    seq = make_tunnel_sequence(num_scans=SEQ_SCANS, azimuth_steps=azimuth, step=0.35, seed=0)
    packed = runner.pack_sequence(seq, base, max_scans=scans, device=dev)
    pose0 = torch.as_tensor(seq.gt_poses[0], dtype=torch.float32)
    timed_scans = _torch_tool.window(packed, lo, scans)
    runs = {}
    for name, change in VARIANTS.items():
        cfg = _torch_tool.ablated(base, **change)
        replay = runner.make_scan_replay(cfg)
        # the warm state, on the same window length as the timed one
        warm, (poses, _, _) = replay(pipeline.init_state(cfg, initial_pose=pose0, device=dev),
                                     _torch_tool.window(packed, 0, warm_hi))
        if name == "base":
            default_poses = poses.cpu().numpy()
        # a copy: the replay's returned state is its step's, which the next call overwrites
        warm = _torch_tool.copy_state(warm)
        runs[name] = (scans - lo, lambda warm=warm: _torch_tool.copy_state(warm),
                      lambda st, outs, replay=replay: replay(st, timed_scans, outputs=outs)[1][0])
    timed = _torch_tool.interleaved(runs, {name: reps for name in runs}, dev)
    rows = {name: _torch_tool.rate_row(timed[name], scans - lo) for name in runs}
    return {name: row["scans_per_s"] for name, row in rows.items()} | {
        "rows": rows, "scans": scans, "warm_window": [0, warm_hi], "timed_window": [lo, scans],
        "azimuth_steps": azimuth, "reps": reps, "default_poses": default_poses.tolist(),
    }

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
