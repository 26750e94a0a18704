#!/usr/bin/env python3
"""Does a B-robot tick cost more than one single scan? Interleaved A/B of
the PyTorch port's single and batched replays on a CUDA card.

The robots are chip_smoke.py's batched phase (production config; robot b
on make_tunnel_sequence(num_scans, azimuth_steps=1800, step=0.30+0.05b,
seed=b)). Each round replays robot 0 alone through runner.make_scan_replay
and all B robots through runner.make_batched_replay, in alternating order
(single first in even rounds), timing every step to a device
synchronisation. It reports, per round and mode, the p50 step time over
the last `--window` steps, and the ratio of the batched tick's p50 to the
single scan's p50 in the same round.

    python tools/torch_batched_bench.py [--robots 4] [--scans 24]
        [--rounds 6] [--window 16] [--out chiprun_out/batched_bench.json]

Imports neither JAX nor locus_tpu; needs a CUDA device.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", type=int, default=4)
    ap.add_argument("--scans", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--window", type=int, default=16, help="last steps of each replay that are timed")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "batched_bench.json"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_batched_bench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import production_config
    from locus_tpu_torch import config as cfg_mod, pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence
    from locus_tpu_torch.metrics import RateReport

    dev = torch.device("cuda")
    cfg = production_config(cfg_mod)
    seqs = [make_tunnel_sequence(num_scans=args.scans, azimuth_steps=1800, step=0.30 + 0.05 * b, seed=b)
            for b in range(args.robots)]
    packed = [runner.pack_sequence(s, cfg, device=dev) for s in seqs]
    stacked = runner.stack_packed(packed)
    poses0 = [s.gt_poses[0] for s in seqs]
    single, batched = runner.make_scan_replay(cfg), runner.make_batched_replay(cfg)

    def run(mode):
        report = RateReport()
        if mode == "single":
            state = pipeline.init_state(cfg, torch.as_tensor(poses0[0], dtype=torch.float32), device=dev)
            single(state, packed[0], report=report)
        else:
            batched(pipeline.init_states(cfg, poses0, device=dev), stacked, report=report)
        return float(np.median(report.durations[-args.window:]) * 1e3)

    run("single"), run("batched")   # warm-up: kernel builds, allocator
    rounds = []
    for r in range(args.rounds):
        order = ("single", "batched") if r % 2 == 0 else ("batched", "single")
        ms = {mode: run(mode) for mode in order}
        rounds.append({"order": list(order), "single_ms_p50": ms["single"], "batched_ms_p50": ms["batched"],
                       "tick_over_scan": ms["batched"] / ms["single"]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    ratios = [r["tick_over_scan"] for r in rounds]
    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "robots": args.robots,
        "scans": args.scans, "window": args.window, "rounds": rounds,
        "tick_over_scan_median": float(np.median(ratios)),
        "tick_over_scan_min_max": [min(ratios), max(ratios)],
        "robot_scans_per_scan_median": float(np.median([args.robots / x for x in ratios])),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
