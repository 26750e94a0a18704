"""What the batched step's own records say over a run of the `fleet` driver:
its captured graph's stamps (`locus_tpu_torch.ops.graph.replay_records`,
the record named `STEP`, one row a tick), read as `replays` reads a single
step's, and the program counters of its GICP loops (`ops.graph.count`),
which the driver keeps in the traced record over the window's passes.

A program without them (no stamps, no counters, a run on the CPU) gives
none, and the readers return None.
"""
from __future__ import annotations

import numpy as np

from harness import replays

STEP = "runner.batched_replay_step"
STAGES = ("stage_s2s", "stage_s2m")     # the stages whose GICP loops count their trips


def mean_ms(per_record, ctx: dict) -> float | None:
    """The mean of `per_record(rec)` over the batched step's replays
    before the profiler (`replays.before_profiler`: the warm pass and the
    window's first pass up to the traced ticks), or None."""
    values = [per_record(r) for r in replays.records(replays.before_profiler(ctx)) if r["step"] == STEP]
    values = np.concatenate(values) if values else np.zeros(0)
    return float(np.mean(values)) if values.size else None


def member_trips(rec: dict):
    """(member-trips run, member-trips needed) of the batched GICP loops
    over the window, summed over STAGES, or None."""
    counters = (rec or {}).get("program_counters")
    if not counters:
        return None
    run = sum(counters.get(f"{s}/gicp.member_trips_run", 0) for s in STAGES)
    needed = sum(counters.get(f"{s}/gicp.member_trips_needed", 0) for s in STAGES)
    return (run, needed) if run > 0 else None


def frozen_trip_share(rec: dict) -> float | None:
    """1 - needed / run, in %: the share of the member-trips that a loop
    ran for members that had stopped (frozen by `torch.where` while a
    slower member iterated)."""
    trips = member_trips(rec)
    return None if trips is None else 100.0 * (1.0 - trips[1] / trips[0])
