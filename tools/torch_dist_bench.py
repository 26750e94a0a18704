#!/usr/bin/env python3
"""What a sharded replay pays on one card: the production replay (48 scans
of chip_smoke.py's tunnel) as tools/torch_dist_smoke.py ranks in three
layouts, alternated round by round in one call:

  one      1 rank, the whole map (no process to share the card with);
  replicas 2 ranks, each the whole map (mesh (2, 1): no collective), so
           the two processes share the card as the sharded ranks do;
  sharded  2 ranks, the map split over both (mesh (1, 2)): the same
           sharing plus the map's gathers.

replicas against one is the cost of sharing the card between processes,
sharded against replicas the cost of the gathers. Prints one JSON line:
each layout's per-rank scans/s over the last 32 scans and p50 ms, per
round, with the card's name and power limit.

    python tools/torch_dist_bench.py [--rounds 2] [--device cuda] [--out DIR]
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import _pathsetup  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
LAYOUTS = {"one": (1, 1), "replicas": (2, 1), "sharded": (2, 2)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--profile", choices=("production", "ci"), default="production")
    ap.add_argument("--scans", type=int, default=48)
    ap.add_argument("--azimuth", type=int, default=1800)
    ap.add_argument("--out", default="chiprun_out/dist_bench")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()

    from locus_tpu_torch.parallel.distributed import spawn_ranks

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seq = ("--profile", args.profile, "--scans", args.scans, "--azimuth", args.azimuth, "--step", 0.35, "--seed", 0)

    def launch(name, world, map_parallel, *extra):
        cmd = [sys.executable, str(ROOT / "tools" / "torch_dist_smoke.py"), "--mode", "pipeline", *map(str, seq),
               "--map-parallel", str(map_parallel), "--device", args.device, "--backend", "gloo",
               "--out", str(out / name), "--timeout", str(args.timeout), *map(str, extra)]
        (out / name).mkdir(exist_ok=True)
        results = spawn_ranks(cmd, world, out / name / "ranks", args.timeout, cwd=ROOT)
        for r, (rc, _, err) in enumerate(results):
            if rc != 0:
                raise RuntimeError(f"{name}: rank {r} exited {rc}: {err[-3000:]}")
        return json.loads(results[0][1].strip().splitlines()[-1])

    # the unsharded poses once, so no measured launch replays a reference
    first = launch("reference", 1, 1)
    ref = out / "reference" / "pipeline_poses.npz"
    rows = {name: [] for name in LAYOUTS}
    order = list(LAYOUTS)
    for k in range(args.rounds):
        for name in (order if k % 2 == 0 else order[::-1]):
            world, map_parallel = LAYOUTS[name]
            t0 = time.perf_counter()
            rec = launch(f"{name}{k}", world, map_parallel, "--ref", ref)
            rows[name].append({
                "round": k, "launch_s": time.perf_counter() - t0, "bit_equal": rec["bit_equal"],
                "scans_per_s_last32": [r["scans_per_s_last"] for r in rec["ranks"]],
                "ms_p50_last32": [r["ms_p50_last"] for r in rec["ranks"]],
            })
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": first.get("device_name", args.device), "nvidia_smi": smi, "scans": args.scans,
                      "profile": args.profile, "layouts": {k: list(v) for k, v in LAYOUTS.items()}, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
