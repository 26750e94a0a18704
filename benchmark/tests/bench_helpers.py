"""Shared pieces of the benchmark's tests: paths, and the tiny cells that a
CPU run can hold (the real widths are the chip's)."""
from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2**31 + 977

# 256 azimuth steps, a 1024-point scan, a 16384-slot map, 8-sweep passes
TINY = {
    "config": {"sensor": {"azimuth_steps": 256},
               "locus": {"scan_capacity": 1024, "points_to_process_in_callback": 800,
                         "mapper": {"map_capacity": 16384, "keyframe_capacity": 1024}}},
    "traffic": {"sweeps_per_pass": 8, "trace_first": 3, "trace_sweeps": 2},
}


def tiny(cell: str) -> dict:
    """TINY with a raw budget that holds the cell's lidars at 256 steps."""
    import copy

    out = copy.deepcopy(TINY)
    out["config"]["locus"]["raw_scan_capacity"] = 16384 if cell.startswith("husky") else 4096
    return out

