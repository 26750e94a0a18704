"""Trace arithmetic: what a torch.profiler trace of a run's traced window
says about the device and the host.

Frozen copy, extended, of `chip_smoke.py`'s `trace_steps` (the compiled
phase's device ops, host launches and syncs a scan) at commit 94db2e9: the
device's busy time is the union of its activity intervals here, not the sum
of kernel times, so that overlapping work is not counted twice; idle gaps
are labelled by the innermost host span open at their middle.

`record(prof, ...)` turns a profiler into a plain dict; the per-layer
readers (`benchmark/metrics/*.py`) read only that dict.
"""
from __future__ import annotations

import numpy as np

HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
# spans that a trace also shows on the device's timeline, which are no work
ANNOTATION_PREFIXES = ("stage_", "benchmark.", "ProfilerStep")
# the profiler's own work on the host, which names no host activity of the run
PROFILER_SPANS = ("Buffer Flush", "Activity Buffer Request", "Resource", "Overhead")


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(ANNOTATION_PREFIXES)


def record(prof, sweeps: int, window_s: float, kernel_inputs=None) -> dict:
    """The traced window of `sweeps` sweeps, `window_s` seconds long by the
    host's clock: device intervals (name, start, end) in seconds, host
    spans likewise, and what the harness knows of each traced sweep's
    kernel inputs (`kernel_inputs`, a list of dicts, or None)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        row = (e.name, tr.start * 1e-6, tr.end * 1e-6)
        if e.device_type == cuda:
            if not _is_annotation(e):
                dev.append(row)
        elif not e.name.startswith(PROFILER_SPANS):
            host.append(row)
    dev.sort(key=lambda r: r[1])
    return {"sweeps": sweeps, "window_s": window_s, "device": dev, "host": host, "kernel_inputs": kernel_inputs}


def busy_intervals(rec: dict) -> list:
    """The union of the device's activity intervals, merged, in order."""
    merged = []
    for _, a, b in rec["device"]:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(rec: dict) -> float:
    return float(sum(b - a for a, b in busy_intervals(rec)))


def host_count(rec: dict, names) -> int:
    return sum(1 for n, _, _ in rec["host"] if n in names)


def host_span_s(rec: dict, name: str) -> float:
    return float(sum(b - a for n, a, b in rec["host"] if n == name))


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and the
    longest idle gaps between device activity, each named by the
    innermost host span open at its middle."""
    by_name: dict = {}
    for n, a, b in rec["device"]:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    iv = busy_intervals(rec)
    gaps = sorted(((iv[k + 1][0] - iv[k][1], iv[k][1], iv[k + 1][0]) for k in range(len(iv) - 1)), reverse=True)[:top]
    if rec["host"]:
        names = [n for n, _, _ in rec["host"]]
        starts = np.array([a for _, a, _ in rec["host"]])
        ends = np.array([b for _, _, b in rec["host"]])
        dur = ends - starts
    labelled = []
    for g, a, b in gaps:
        label = "no host span"
        if rec["host"]:
            mid = 0.5 * (a + b)
            open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if open_.size:
                label = names[int(open_[np.argmin(dur[open_])])]
        labelled.append([label, float(g)])
    return {"device_ops": [[n, float(s)] for n, s in ops], "idle_gaps": labelled}
