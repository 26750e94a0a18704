#!/usr/bin/env python3
"""A/B: the GICP's inner Gauss-Newton trip count, 3 against 2, in both
registration stages (tools/exp_inner.py on locus_tpu_torch). Not part of
the benchmark.

For each setting: the ATE (unaligned, against ground truth) of a fresh
replay of each of the tunnel, urban and cave worlds
(make_world_sequence, 60 scans, 900 azimuth steps), and the benchmark's
throughput: 48 scans of make_tunnel_sequence(azimuth_steps=1800,
step=0.35, seed=0) at bench.py's production config, one untimed replay,
then the timed replays from fresh states, round by round over the two
settings (`runner.make_scan_replay`, as the JAX tool); the best rep's
scans/s, and the ATE of the replays (every timed rep's poses equal the
untimed one's bit for bit). The JAX
tool's fourth world, the reference's garage PCDs (`ate_garage`), lies
outside the repository and is left out.

Prints ONE JSON line with exp_inner.py's keys (inner3 and inner2, each
with ate_tunnel, ate_urban, ate_cave, scans_per_s and ate_bench) and,
beside them, every rep's rate and the B1/B2 launches a scan of the timed
replays (in each setting's row), inner 3's poses on the tunnel world
(`default_poses`), and the card's name and power limit.

    python tools/torch_exp_inner.py [--device cpu] [--scans N] [--world-scans N] [--reps N] [--json out.json]

`--scans N` replays only the first N scans of the benchmark's sequence,
`--world-scans N` of each world's.
Runs on the CUDA device unless --device cpu, which selects bench.py's CI
fallback config with every sequence at 512 azimuth steps. Imports
neither JAX nor the JAX package.
"""
import argparse
import json

import _torch_tool

SEQ_SCANS, WORLD_SCANS = 48, 60
WORLDS = ("tunnel", "urban", "cave")
SETTINGS = {"inner3": 3, "inner2": 2}


def run(cfg0, scans: int, world_scans: int, azimuth: int, world_azimuth: int, reps: int, dev) -> dict:
    import torch

    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence, make_world_sequence
    from locus_tpu_torch.metrics import ate_rmse

    bench_seq = make_tunnel_sequence(num_scans=SEQ_SCANS, azimuth_steps=azimuth, step=0.35, seed=0)
    bench_packed = runner.pack_sequence(bench_seq, cfg0, max_scans=scans, device=dev)
    worlds = {w: make_world_sequence(w, num_scans=WORLD_SCANS, azimuth_steps=world_azimuth) for w in WORLDS}

    def fresh(cfg, seq):
        pose0 = torch.as_tensor(seq.gt_poses[0], dtype=torch.float32)
        return lambda: pipeline.init_state(cfg, initial_pose=pose0, device=dev)

    def ate(poses, seq):
        return ate_rmse(poses[:, :3, 3], seq.gt_poses[: poses.shape[0], :3, 3], align=False)

    report, runs = {}, {}
    for key, inner in SETTINGS.items():
        cfg = _torch_tool.ablated(cfg0, inner_iterations=inner)
        replay = runner.make_scan_replay(cfg)
        row = {}
        for w, seq in worlds.items():
            packed = runner.pack_sequence(seq, cfg, max_scans=world_scans, device=dev)
            poses = replay(fresh(cfg, seq)(), packed)[1][0].cpu().numpy()
            row[f"ate_{w}"] = ate(poses, seq)
            if key == "inner3" and w == "tunnel":
                default_poses = poses
        report[key] = row
        runs[key] = (scans, fresh(cfg, bench_seq),
                     lambda st, outs, replay=replay: replay(st, bench_packed, outputs=outs)[1][0])
    timed = _torch_tool.interleaved(runs, {key: reps for key in runs}, dev)
    for key in runs:
        report[key] |= _torch_tool.rate_row(timed[key], scans) | {"ate_bench": ate(timed[key]["poses"], bench_seq)}
        print(json.dumps({key: report[key]}), flush=True)
    return report | {"scans": scans, "world_scans": world_scans, "azimuth_steps": azimuth,
                     "world_azimuth_steps": world_azimuth, "reps": reps, "default_poses": default_poses.tolist()}

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _torch_tool.add_experiment_args(ap, scans=SEQ_SCANS, reps=3)
    ap.add_argument("--world-scans", type=int, default=WORLD_SCANS, choices=range(1, WORLD_SCANS + 1), metavar="N",
                    help=f"replay only the first N of each world's {WORLD_SCANS} scans")
    args = ap.parse_args()
    dev = _torch_tool.device(args.device)
    cfg, azimuth = _torch_tool.experiment_setup(dev)
    world_azimuth = 900 if dev.type == "cuda" else azimuth
    result = run(cfg, args.scans, args.world_scans, azimuth, world_azimuth, args.reps, dev)
    result |= _torch_tool.device_record(dev)
    print(json.dumps(result), flush=True)
    _torch_tool.write_json(args.json, result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
