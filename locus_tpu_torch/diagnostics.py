"""Diagnostics aggregation and observability records (counterpart of
`locus_tpu/diagnostics.py`; host-side numpy, no tensors), and the
stage timer of the program's host spans.

Native replacement for the reference's /diagnostics publishing
(diagnostic_msgs aggregation, Locus.cc:553-561;
PointCloudOdometry.cc:367-380 GetDiagnostics) and the drop-rate /
rate/delay instrumentation (Locus.cc:401-423; scripts/profiler.py).
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from torch.profiler import record_function

# diagnostic_msgs levels
OK = 0
WARN = 1
ERROR = 2


@dataclass
class ModuleStatus:
    name: str
    level: int = OK
    message: str = "Healthy"


@dataclass
class DiagnosticRecord:
    """Per-scan diagnostic snapshot (host-side, built from StepOutput)."""

    stamp: float
    scan_count: int
    statuses: list = field(default_factory=list)

    def level(self) -> int:
        return max((s.level for s in self.statuses), default=OK)

    def to_dict(self) -> dict:
        return {
            "stamp": self.stamp,
            "scan_count": self.scan_count,
            "level": self.level(),
            "statuses": [
                {"name": s.name, "level": s.level, "message": s.message}
                for s in self.statuses
            ],
        }


def from_step_output(
    stamp: float, out, scan_count: int = 0, stats_window_dropped: int = 0
) -> DiagnosticRecord:
    """Build the aggregate record from a StepOutput (mirrors the modules
    the reference reports: odometry, localization, mapper)."""
    rec = DiagnosticRecord(stamp=stamp, scan_count=scan_count)
    odo_ok = bool(out.scan_to_scan_accepted)
    rec.statuses.append(
        ModuleStatus(
            "point_cloud_odometry",
            OK if odo_ok else ERROR,
            "Healthy" if odo_ok else "scan-to-scan delta rejected",
        )
    )
    loc_ok = bool(out.scan_to_map_accepted)
    rec.statuses.append(
        ModuleStatus(
            "point_cloud_localization",
            OK if loc_ok else WARN,
            "Healthy" if loc_ok else "scan-to-map delta rejected / no map",
        )
    )
    rec.statuses.append(
        ModuleStatus(
            "mapper",
            OK if int(out.map_size) > 0 else WARN,
            f"map_size={int(out.map_size)}",
        )
    )
    if stats_window_dropped > 0:
        rec.statuses.append(
            ModuleStatus("scan_input", WARN, f"dropped={stats_window_dropped}")
        )
    # xy cross-section (b_publish_xy_cross_section; the reference
    # publishes the localizer-space area on its own topic)
    xsec = getattr(out, "xy_cross_section", None)
    if xsec is not None and float(xsec) >= 0:
        rec.statuses.append(
            ModuleStatus("space_monitor", OK, f"xy_cross_section={float(xsec):.1f}")
        )
    return rec


class DiagnosticsLog:
    """Rolling log with the reference's statistics_time_window reporting."""

    def __init__(self, window_s: float = 5.0):
        self.window_s = window_s
        self.records: list[DiagnosticRecord] = []

    def add(self, rec: DiagnosticRecord):
        self.records.append(rec)

    def window(self, now: Optional[float] = None):
        now = now if now is not None else (self.records[-1].stamp if self.records else 0.0)
        lo = now - self.window_s
        return [r for r in self.records if r.stamp >= lo]

    def summary(self) -> dict:
        w = self.window()
        if not w:
            return {"count": 0}
        return {
            "count": len(w),
            "worst_level": max(r.level() for r in w),
            "error_fraction": sum(1 for r in w if r.level() >= ERROR) / len(w),
        }

    def dump_jsonl(self, path: str):
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_dict()) + "\n")


class _Span:
    """One span of a StageTimer: a `record_function` of its name, and its
    start and end on the host's `time.perf_counter_ns` clock."""

    __slots__ = ("timer", "stage", "scope", "t0")

    def __init__(self, timer: "StageTimer", stage: str):
        self.timer, self.stage = timer, stage

    def __enter__(self):
        self.scope = record_function(self.stage)
        self.scope.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.timer.span(self.stage, self.t0, time.perf_counter_ns())
        self.scope.__exit__(*exc)


class StageTimer:
    """Per-stage wall timing (the reference's lidar_callback_duration /
    scan_to_scan_duration / scan_to_map_duration topics). Kernel launches
    return before the card has run them, so a stage timed around card work
    must end in a host read of its result (LiveSession times a scan up to
    the fetch of its pose).

    `time(stage)` is also a `record_function(stage)`, so a profiler trace
    shows the same span, and keeps the span's (start, end) in
    `time.perf_counter_ns` (`spans`). Each stage keeps its last `keep`
    samples and spans."""

    def __init__(self, keep: int = 1 << 16):
        self.keep = keep
        self.samples: dict[str, deque] = {}
        self.intervals: dict[str, deque] = {}

    def record(self, stage: str, seconds: float):
        self.samples.setdefault(stage, deque(maxlen=self.keep)).append(seconds)

    def span(self, stage: str, start_ns: int, end_ns: int):
        """Record a span of `stage` from `start_ns` to `end_ns`."""
        self.record(stage, (end_ns - start_ns) * 1e-9)
        self.intervals.setdefault(stage, deque(maxlen=self.keep)).append((start_ns, end_ns))

    def time(self, stage: str) -> _Span:
        return _Span(self, stage)

    def spans(self, stage: str) -> np.ndarray:
        """(n, 2) int64: the kept spans of `stage`, (start, end) in ns."""
        return np.array(self.intervals.get(stage, ()), dtype=np.int64).reshape(-1, 2)

    def summary(self) -> dict:
        return {
            k: {
                "mean_s": float(np.mean(v)),
                "p95_s": float(np.percentile(v, 95)),
                "count": len(v),
            }
            for k, v in self.samples.items()
            if v
        }


# The program's own spans, process-wide: the merger's `merger.observe`,
# `merger.health` and `merger.merge`, and the sharded deployments'
# `gather_ranked`.
process_timer = StageTimer()
