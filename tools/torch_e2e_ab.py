#!/usr/bin/env python3
"""Interleaved end-to-end A/B of two checkouts of the PyTorch port on one
CUDA card: another checkout (the base, for example the parent commit
unpacked with `git archive` into the ignored `build/ab/base`) against this
one.

Each run is `tools/torch_batched_bench.py --rounds 1` started in a
checkout's root, in its own process: it builds that checkout's kernels,
warms up, then replays robot 0 alone (make_scan_replay) and all 4 robots
(make_batched_replay) on chip_smoke.py's batched-phase tunnels, each step
timed to a device synchronisation. The runs go base, new, new, base
(`--rounds` times); the tool reports each run's p50 scan and tick times
over the last 16 steps, their medians per checkout, and the scans/s and
robot-scans/s those medians give.

    python tools/torch_e2e_ab.py --base build/ab/base [--rounds 2]
        [--out chiprun_out/e2e_ab.json]

Imports neither JAX nor locus_tpu; needs a CUDA device.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def bench(root: Path, robots: int) -> dict:
    """One torch_batched_bench.py round in checkout `root` (its record goes
    to the ignored build/ab/ of this checkout)."""
    out = ROOT / "build" / "ab" / "e2e_bench.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, str(root / "tools" / "torch_batched_bench.py"), "--rounds", "1",
                    "--robots", str(robots), "--out", str(out)], cwd=root, check=True)
    return json.loads(out.read_text())["rounds"][0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the base checkout")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of base, new, new, base")
    ap.add_argument("--robots", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "e2e_ab.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_e2e_ab: needs a CUDA device", file=sys.stderr)
        return 2
    roots = {"base": Path(args.base).resolve(), "new": ROOT}
    runs = []
    for _ in range(args.rounds):
        for label in ("base", "new", "new", "base"):
            r = bench(roots[label], args.robots)
            runs.append({"checkout": label, "scan_ms_p50": r["single_ms_p50"], "tick_ms_p50": r["batched_ms_p50"]})
            print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for label in roots:
        scan = statistics.median(r["scan_ms_p50"] for r in runs if r["checkout"] == label)
        tick = statistics.median(r["tick_ms_p50"] for r in runs if r["checkout"] == label)
        summary[label] = {"scan_ms": scan, "tick_ms": tick, "scans_per_s": 1e3 / scan,
                          "robot_scans_per_s": args.robots * 1e3 / tick}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "base": args.base,
              "rounds": args.rounds, "robots": args.robots, "runs": runs, "median": summary,
              "new_over_base": {k: summary["new"][k] / summary["base"][k] for k in ("scan_ms", "tick_ms")}}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
