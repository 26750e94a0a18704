#!/usr/bin/env python3
"""Experiment 2: the per-scan cost of each ablated feature at held map
occupancy (tools/exp_gap2.py on locus_tpu_torch). Not part of the
benchmark.

bench.py's production config on 96 scans of
make_tunnel_sequence(azimuth_steps=1800, step=0.35, seed=0). The default
config replays scans 0-48 from a fresh state: the warm state (its map
populated). Every variant of tools/exp_gap2.py:100-136 then replays the
continuation, scans 48-96, from its own copy of that one warm state, so
the nearest-neighbour occupancy and the convergence difficulty are the
same for all and only the ablated feature differs. Two variants change
the replay body itself (exp_gap2.py:44-64): `warm_no_seq_stats` steps
without the scan's sequence number (no drop-rate statistics) and
`warm_no_sensor_push` pushes no IMU or odometry window (with fusion mode
0); the others replay through `runner.make_scan_replay`. Each variant
gets one untimed replay (its keyframe count), then the timed replays run
round by round over the variants, and every one's poses equal its
variant's untimed replay's bit for bit. `--scans N` cuts
the windows to the sequence's first N scans: warm 0..N/2, timed N/2..N.

Prints ONE JSON line with exp_gap2.py's keys (warm_map_size, warm_kf, and
a row of scans_per_s, ms_per_scan and kf_inserted for each variant, best
of the reps) and, beside them, every rep's rate and the B1/B2 launches a
scan (each row), the default config's poses over the warm window
(`default_poses`), and the card's name and power limit.

    python tools/torch_exp_gap2.py [--device cpu] [--scans N] [--reps N] [--json out.json]

Runs on the CUDA device unless --device cpu, which selects bench.py's CI
fallback config at 512 azimuth steps. Imports neither JAX nor the JAX
package.
"""
import argparse
import json

import _torch_tool

SEQ_SCANS = 96
# tools/exp_gap2.py:100-136: (`_torch_tool.ablated` arguments, replay-body
# switches of `_torch_tool.make_replay`)
VARIANTS = {
    "warm_default": ({}, {}),
    "warm_no_kf": (dict(keyframes=False, msw=False), {}),
    "warm_no_msw_gate": (dict(msw=False), {}),
    "warm_no_cov": (dict(icp_covariance=False), {}),
    "warm_inner2": (dict(inner_iterations=2), {}),
    "warm_no_adaptive_leaf": (dict(adaptive_leaf=False), {}),
    "warm_fusion_none": (dict(fusion_mode=0), {}),
    "warm_no_seq_stats": ({}, dict(with_seq=False)),
    "warm_no_sensor_push": (dict(fusion_mode=0), dict(with_sensors=False)),
}


def run(cfg0, scans: int, azimuth: int, reps: int, dev) -> dict:
    import torch

    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    half = scans // 2
    seq = make_tunnel_sequence(num_scans=SEQ_SCANS, azimuth_steps=azimuth, step=0.35, seed=0)
    packed = runner.pack_sequence(seq, cfg0, max_scans=scans, device=dev)
    pose0 = torch.as_tensor(seq.gt_poses[0], dtype=torch.float32)
    outs = []
    warm, (poses, _, _) = runner.make_scan_replay(cfg0)(pipeline.init_state(cfg0, initial_pose=pose0, device=dev),
                                                        _torch_tool.window(packed, 0, half), outputs=outs)
    report = {"warm_map_size": int(warm.map.cloud.mask.sum()),
              "warm_kf": sum(int(o.keyframe_inserted) for o in outs)}
    print(json.dumps(report), flush=True)
    second = _torch_tool.window(packed, half, scans)
    runs = {}
    for name, (change, body) in VARIANTS.items():
        replay = _torch_tool.make_replay(_torch_tool.ablated(cfg0, **change), **body)
        runs[name] = (scans - half, lambda: _torch_tool.copy_state(warm),
                      lambda st, outs, replay=replay: replay(st, second, outputs=outs)[1][0])
    timed = _torch_tool.interleaved(runs, {name: reps for name in runs}, dev)
    rows = {name: _torch_tool.rate_row(timed[name], scans - half)
            | {"kf_inserted": sum(int(o.keyframe_inserted) for o in timed[name]["outputs"])} for name in runs}
    return report | rows | {"scans": scans, "warm_window": [0, half], "timed_window": [half, scans],
                            "azimuth_steps": azimuth, "reps": reps, "default_poses": poses.cpu().numpy().tolist()}

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
