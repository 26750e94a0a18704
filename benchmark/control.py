#!/usr/bin/env python3
"""The control of the comparison that decides `correct`: the
configuration's plain reference put in the program's place at a lower
precision (bfloat16; the configurations state float32), on a cell's own
traffic at its own size, judged against the same reference at float64
exactly as a run judges the program. It has to come out as not correct.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

Prints one JSON line a seed: the control's compared numbers beside the
cell's limits, and whether it passed them. The benchmark's own runs do not
run it; it needs a CUDA card (`--device cpu` for the tests' tiny cells).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))


LOW = "bfloat16"    # the nearest precision below the configurations' float32


def control(root: Path, name: str, seed: int, seconds: float, device: str = "cuda",
            overrides: dict | None = None) -> dict:
    import torch

    from harness import cells, check

    c = cells.cell(root, cells.load(root), name)
    if overrides:
        c = cells.deep_merge(c, overrides)
    conf, mix = c["config"], c["traffic"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    robots = cells.driver(root, mix["driver"]).traffic(conf, mix, seed, seconds, dev)
    refs = check.reference(root, conf, robots, dev)
    low = check.reference(root, conf, robots, dev, dtype=getattr(torch, LOW))
    numbers, per = check.gaps([(r, 0, p, z) for r, (p, z) in enumerate(low)], refs)
    correct, failed, shown = check.judge(numbers, per, check.load_limits(root, name))
    return {"workload": name, "seed": seed, "dtype": LOW, "sweeps": int(per.shape[0]), "correct": correct,
            "failed": failed, "check": shown}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0, help="the window, for a driver whose traffic depends on it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(ROOT, args.workload, seed, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
