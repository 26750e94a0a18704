#!/usr/bin/env python3
"""Run one benchmark cell once, on the CUDA card this process sees.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the kernels from the checkout's build
cache, the traffic made from the seed on the card, the warm-up) is timed
from the start of this process to the start of the window. The window
measures the cell's end-to-end metrics (--trace 0), or, with --trace 1,
traces a segment of it and reports the per-layer metrics. After the window
the program's state is freed and the configuration's plain reference
replays the same sweeps; the last line of standard output is one JSON
object, and the numbers compared with the reference, each beside its
limit, are the last lines of standard error.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and
3 if any of the JAX modules or the JAX package were loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "locus_tpu")


def environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout (the port builds its
    kernels into build/kernels/ itself), and no library loading JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             overrides: dict | None = None, t0: float | None = None) -> tuple[dict, list]:
    """One run of cell `name`: (the result object, the lines for standard
    error, the check's last). `device` and `overrides` (laid over the
    cell's config and traffic) exist for the tests, which run tiny cells
    on the CPU."""
    import torch

    from harness import cells, check, program, trace

    t0 = T0 if t0 is None else t0
    bench = cells.load(root)
    c = cells.cell(root, bench, name)
    if overrides:
        c = cells.deep_merge(c, overrides)
    conf, mix = c["config"], c["traffic"]
    drive = cells.driver(root, mix["driver"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    marks = [("imports", time.perf_counter())]
    cfg = program.build_config(conf["locus"])
    robots = drive.traffic(conf, mix, seed, seconds, dev)
    program.sync(dev)
    marks.append(("traffic", time.perf_counter()))
    driver = drive.Driver(cfg, conf, mix, robots, dev)
    marks.append(("program set-up", time.perf_counter()))
    driver.setup()
    program.sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    w = driver.window(seconds, traced)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    values = dict(w.values, setup_s=setup_s)

    rec = w.trace
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the plain reference over the same sweeps, after the program's state is gone
    t_ref = time.perf_counter()
    numbers, per = check.gaps(w.outputs, check.reference(root, conf, robots, dev))
    correct, failed, shown = check.judge(numbers, per, check.load_limits(root, name))
    t_ref = time.perf_counter() - t_ref

    device_block = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                    "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                    "count": int(c["workload"]["chips"]), "memory_peak_bytes": peak,
                    "power_limit_w": power_limit_w() if dev.type == "cuda" else None}
    result = {"correct": correct, "attempted": int(per.shape[0]), "failed": failed}
    if traced:
        metrics = {}
        if rec is not None:
            ctx = {"cell": name, "config": conf, "traffic": mix}
            for m in cells.metrics(bench, "per_layer", name):
                v = cells.reader(root, m["name"])(rec, ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
            device_block["busy_s"] = trace.busy_s(rec)
            device_block["window_s"] = rec["window_s"]
    else:
        missing = [m["name"] for m in cells.metrics(bench, "end_to_end", name) if m["name"] not in values]
        if missing:
            raise KeyError(f"driver {mix['driver']!r} measured none of {missing} for cell {name!r}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cells.metrics(bench, "end_to_end", name)}
    result["metrics"] = metrics
    result["device"] = device_block
    if traced and rec is not None:
        result["breakdown"] = trace.breakdown(rec)
    lines = list(w.notes)
    prev, parts = t0, []
    for label, t in marks:
        parts.append(f"{label} {t - prev:.3f}")
        prev = t
    lines.append(f"set-up {setup_s:.3f} s ({', '.join(parts)} s); the reference and the check {t_ref:.3f} s")
    for k, v in shown.items():
        lines.append(f"check {k} {v['value']!r} limit {v['limit']!r}")
    result["check"] = shown
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment(ROOT)

    import torch

    torch.set_num_threads(1)

    from harness import cells

    try:
        chips = int(cells.cell(ROOT, cells.load(ROOT), args.workload)["workload"]["chips"])
    except (OSError, KeyError, ValueError) as e:
        print(f"no such cell {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
