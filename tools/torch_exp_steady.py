#!/usr/bin/env python3
"""Experiment: fresh-run against steady-state replay rate, and the rate
over a longer run (tools/exp_steady.py on locus_tpu_torch). Not part of
the benchmark.

bench.py's production config on 144 scans of
make_tunnel_sequence(azimuth_steps=1800, step=0.35, seed=0), four
windows (exp_steady.py:61-78):
- fresh48: scans 0-48 from a fresh state (the benchmark's window);
- steady32: scans 16-48 from the state after a 16-scan warm-up;
- fresh144: scans 0-144 from a fresh state;
- steady128: scans 16-144 from the state after the same warm-up.
Each window gets one untimed replay, then its timed replays (3 for the
short windows, 2 for the long ones) run round by round over the
windows (`runner.make_scan_replay`, as the JAX tool); each replay starts
from its own copy of its starting state, and every timed one's poses
equal its window's untimed replay's bit for bit. The best rep's scans/s
is the window's result. `--scans N` cuts
the windows to the sequence's first N scans in the same proportions:
windows of N/3 and N scans, a warm-up of N/9 (the keys carry the
lengths).

Prints ONE JSON line with exp_steady.py's keys (fresh48, steady32,
fresh144, steady128: each window's best scans/s) and, beside them,
`rows` (each window's every rep, ms a scan and B1/B2 launches a scan),
the fresh state's poses over the short window (`default_poses`), and
the card's name and power limit.

    python tools/torch_exp_steady.py [--device cpu] [--scans N] [--reps N] [--json out.json]

--reps sets the short windows' reps (the long ones take one fewer, at
least one). Runs on the CUDA device unless --device cpu, which selects
bench.py's CI fallback config at 512 azimuth steps. Imports neither JAX
nor the JAX package.
"""
import argparse
import json

import _torch_tool


SEQ_SCANS = 144


def windows(scans: int) -> dict:
    """{key: (first scan, last scan + 1, starts after the warm-up, long)}
    of exp_steady.py's four windows at `scans` (144: its own keys)."""
    short, warm = scans // 3, scans // 9
    return {
        f"fresh{short}": (0, short, False, False),
        f"steady{short - warm}": (warm, short, True, False),
        f"fresh{scans}": (0, scans, False, True),
        f"steady{scans - warm}": (warm, scans, True, True),
    }


def run(cfg, scans: int, azimuth: int, reps: int, dev) -> dict:
    import torch

    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    seq = make_tunnel_sequence(num_scans=SEQ_SCANS, azimuth_steps=azimuth, step=0.35, seed=0)
    packed = runner.pack_sequence(seq, cfg, max_scans=scans, device=dev)
    pose0 = torch.as_tensor(seq.gt_poses[0], dtype=torch.float32)
    replay = runner.make_scan_replay(cfg)

    def fresh():
        return pipeline.init_state(cfg, initial_pose=pose0, device=dev)

    wins = windows(scans)
    # a copy: the replay's returned state is its step's, which the next call overwrites
    warm = _torch_tool.copy_state(replay(fresh(), _torch_tool.window(packed, 0, scans // 9))[0])
    runs, counts = {}, {}
    for key, (lo, hi, after_warm, long) in wins.items():
        start = (lambda: _torch_tool.copy_state(warm)) if after_warm else fresh
        runs[key] = (hi - lo, start,
                     lambda st, outs, sub=_torch_tool.window(packed, lo, hi): replay(st, sub, outputs=outs)[1][0])
        counts[key] = max(reps - 1, 1) if long else reps
    timed = _torch_tool.interleaved(runs, counts, dev)
    rows = {key: _torch_tool.rate_row(timed[key], n) | {"window": list(wins[key][:2])}
            for key, (n, _, _) in runs.items()}
    return {key: row["scans_per_s"] for key, row in rows.items()} | {
        "rows": rows, "scans": scans, "warm_up": scans // 9, "azimuth_steps": azimuth, "reps": counts,
        "default_poses": timed[f"fresh{scans // 3}"]["poses"].tolist(),
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
