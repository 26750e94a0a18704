"""Replay arithmetic: what the program's own stamps of its captured steps
say about each replay (`locus_tpu_torch.ops.graph.replay_records`: the
device's clock at each replay's head, tail and each stage's entry and
exit, captured into the graph; the host's at each call) and what its
process-wide spans say about the merger (`diagnostics.process_timer`).

The readers under `benchmark/metrics/` take the mean of one value a
replay (or a sweep) over the replays a traced run makes before its
profiler starts (`before_profiler`): after `torch.profiler` has traced
the captured graph, the graph runs up to 1.7x slower on the device for
tens of seconds (PERF.md, §6), so the replays after it say nothing of
the program. Means, so that the stages and the rest add up to the graph, and
the graph and the gap to the wall time a sweep. A program that keeps no
such record (one without the stamps, the flag
`b_enable_computation_time_profiling` off, or a run on the CPU, where no
graph is captured) gives none, and the readers return None.
"""
from __future__ import annotations

import numpy as np

NS_PER_MS = 1e6


def before_profiler(ctx: dict) -> int | None:
    """How many replays a traced run of the `replay` driver makes before
    its profiler starts: the set-up's warm pass of `sweeps_per_pass`
    sweeps, then the window's first pass up to `trace_first`. None where
    the traffic does not say."""
    mix = (ctx or {}).get("traffic") or {}
    if "sweeps_per_pass" not in mix or "trace_first" not in mix:
        return None
    return int(mix["sweeps_per_pass"]) + int(mix["trace_first"])


def records(upto: int | None = None) -> list:
    """The program's replay records, or [] where it keeps none; with
    `upto`, each cut to its first `upto` replays (a ring that wrapped has
    lost them, and is left out)."""
    from locus_tpu_torch.ops import graph

    read = getattr(graph, "replay_records", None)
    out = read() if read is not None else []
    if upto is None:
        return out
    return [dict(rec, device_ns=rec["device_ns"][:upto], host_ns=rec["host_ns"][:upto],
                 replays=min(upto, rec["replays"]))
            for rec in out if rec["replays"] <= rec["device_ns"].shape[0]]


def ordered(rec: dict) -> tuple:
    """(device rows, host rows) of `rec` in replay order: a ring that
    wrapped holds its oldest row at `replays` modulo its rows."""
    dev, host = rec["device_ns"], rec["host_ns"]
    rows = dev.shape[0]
    if rec["replays"] > rows:
        shift = rec["replays"] % rows
        dev, host = np.roll(dev, -shift, axis=0), np.roll(host, -shift, axis=0)
    return dev, host


def stage_ms(rec: dict, name: str) -> np.ndarray:
    """Per replay, exit - entry of stage `name` on the device (the sum over
    its pairs, should the step hold more than one); a replay where a stamp
    of the stage is missing (0) is left out, and a step without the stage
    gives none."""
    dev, _ = ordered(rec)
    pairs = [slots for stage, slots in zip(rec["stages"], rec["stage_slots"]) if stage == name]
    if not pairs:
        return np.zeros(0)
    entry = dev[:, [a for a, _ in pairs]]
    exit_ = dev[:, [b for _, b in pairs]]
    ran = (entry > 0).all(axis=1) & (exit_ > 0).all(axis=1)
    return (exit_ - entry)[ran].sum(axis=1) / NS_PER_MS


def graph_ms(rec: dict) -> np.ndarray:
    """Per replay, tail - head on the device."""
    dev, _ = ordered(rec)
    head, tail = dev[:, rec["head_slot"]], dev[:, rec["tail_slot"]]
    ran = (head > 0) & (tail > 0)
    return (tail - head)[ran] / NS_PER_MS


def _between(rec: dict):
    """For each pair of consecutive replays: (this one's tail, the next
    one's head, the next call's start on the device's clock), in ns."""
    dev, host = ordered(rec)
    tail = dev[:-1, rec["tail_slot"]]
    head = dev[1:, rec["head_slot"]]
    call = host[1:, 0] + rec["offset_ns"]
    ok = (tail > 0) & (head > 0)
    return tail[ok], head[ok], call[ok]


def gap_ms(rec: dict) -> np.ndarray:
    """Per pair of consecutive replays, the next one's head - this one's
    tail on the device: idle time, the input copies ahead of the replay,
    the launch, and any device work of the host between the two calls."""
    tail, head, _ = _between(rec)
    return (head - tail) / NS_PER_MS


def host_wait_ms(rec: dict) -> np.ndarray:
    """The part of each gap before the host began the next call:
    clamp(next call's start on the device's clock - tail, 0, gap)."""
    tail, head, call = _between(rec)
    return np.clip(call - tail, 0, head - tail) / NS_PER_MS


def merger_ms(rec: dict, timer) -> np.ndarray:
    """Per pair of consecutive calls of `rec`'s step, the summed host time
    of the merger's spans (`merger.*` of `timer`) that started between
    the two calls: the merger's share of each sweep."""
    spans = [timer.spans(name) for name in sorted(timer.intervals) if name.startswith("merger.")]
    if not spans:
        return np.zeros(0)
    spans = np.concatenate(spans)
    _, host = ordered(rec)
    calls = host[:, 0]
    sweep = np.searchsorted(calls, spans[:, 0], side="right")    # spans before call k+1 go to sweep k+1
    inside = (sweep > 0) & (sweep < len(calls))
    sums = np.bincount(sweep[inside] - 1, weights=(spans[inside, 1] - spans[inside, 0]), minlength=len(calls) - 1)
    had = np.bincount(sweep[inside] - 1, minlength=len(calls) - 1) > 0
    return sums[had] / NS_PER_MS


def mean_ms(per_record, ctx: dict) -> float | None:
    """The mean of every record's values (`per_record(rec)`) over the
    replays before the profiler (`before_profiler(ctx)`), or None where
    there are none."""
    values = [per_record(rec) for rec in records(before_profiler(ctx))]
    values = np.concatenate(values) if values else np.zeros(0)
    return float(np.mean(values)) if values.size else None


def program_timer():
    """The program's process-wide stage timer, or None where it keeps none."""
    from locus_tpu_torch import diagnostics

    timer = getattr(diagnostics, "process_timer", None)
    return timer if hasattr(timer, "spans") else None
