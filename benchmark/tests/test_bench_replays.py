"""The replay arithmetic (`harness/replays.py`) on synthetic records with
a known clock offset, and the readers that use it, which find nothing to
read on the CPU (no graph is captured there)."""
from __future__ import annotations

import json

import numpy as np
import pytest

from bench_helpers import ROOT, SEED, tiny

MS = 1_000_000      # ns
OFFSET = 7 * MS     # the device's clock less the host's
NEW = [f"step.{s}.device_ms_per_scan" for s in ("pre", "prior", "s2s", "ann", "s2m", "kf", "msw")] + [
    "step.graph_ms_per_scan", "step.gap_ms_per_scan", "step.host_wait_ms_per_scan", "merger.span_ms_per_scan"]


def _record(rows, replays=None, stages=("stage_a", "stage_b")):
    """A record of `rows` (device rows: head, each stage's entry and exit,
    tail; host rows: call, replay, return), as `replay_records` gives it."""
    dev = np.array([r[0] for r in rows], dtype=np.int64)
    host = np.array([r[1] for r in rows], dtype=np.int64)
    return {"step": "test", "replays": len(rows) if replays is None else replays, "stages": list(stages),
            "stage_slots": [(1 + 2 * k, 2 + 2 * k) for k in range(len(stages))], "head_slot": 0,
            "tail_slot": 1 + 2 * len(stages), "device_ns": dev, "host_ns": host,
            "host_stamps": ("call", "replay", "return"), "offset_ns": OFFSET, "bracket_ns": 20_000}


def _row(t, a, b, graph, call):
    """A replay whose head is at t ms on the device, stage_a taking a ms and
    stage_b b ms right after it, its tail at t + graph; its call at `call`
    ms on the host's clock."""
    head = t * MS
    return ([head, head, head + a * MS, head + a * MS, head + (a + b) * MS, head + graph * MS],
            [call * MS, call * MS + 1, call * MS + 2])


ROWS = [
    # the device's clock is the host's + 7 ms
    _row(100, 2, 3, 6, 90),      # called 3 ms before its head (device clock 97)
    _row(108, 2, 4, 7, 101),     # called at device 108: the host kept the device waiting 2 ms after tail 106
    _row(116, 1, 3, 5, 100),     # called at device 107, before the last tail (115): no wait
    _row(130, 2, 3, 6, 127),     # called at device 134, after its own head: the wait is clamped to the gap
]


def test_stage_durations_graph_gaps_and_host_wait():
    from harness import replays

    rec = _record(ROWS)
    np.testing.assert_allclose(replays.stage_ms(rec, "stage_a"), [2, 2, 1, 2])
    np.testing.assert_allclose(replays.stage_ms(rec, "stage_b"), [3, 4, 3, 3])
    np.testing.assert_allclose(replays.graph_ms(rec), [6, 7, 5, 6])
    np.testing.assert_allclose(replays.gap_ms(rec), [2, 1, 9])
    np.testing.assert_allclose(replays.host_wait_ms(rec), [2, 0, 9])


def test_a_stage_that_did_not_run_is_left_out():
    from harness import replays

    rows = [list(map(list, r)) for r in ROWS]
    rows[1][0][3] = rows[1][0][4] = 0                  # stage_b's stamps of the second replay never written
    rec = _record(rows)
    np.testing.assert_allclose(replays.stage_ms(rec, "stage_b"), [3, 3, 3])
    np.testing.assert_allclose(replays.stage_ms(rec, "stage_a"), [2, 2, 1, 2])
    assert replays.stage_ms(rec, "stage_c").size == 0


def test_a_ring_that_wrapped_is_read_in_order():
    """Six replays in a ring of four rows: rows 0 and 1 hold replays 4 and
    5, rows 2 and 3 replays 2 and 3; read in order, the gaps are those of
    replays 2-5."""
    from harness import replays

    six = [_row(100 + 10 * k, 1, 1, 4 + k % 2, 95 + 10 * k) for k in range(6)]
    rec = _record(six[4:] + six[2:4], replays=6)
    in_order = _record(six[2:])
    for fn in (replays.graph_ms, replays.gap_ms, replays.host_wait_ms):
        np.testing.assert_allclose(fn(rec), fn(in_order))
    np.testing.assert_allclose(replays.gap_ms(rec), [6, 5, 6])


class _Timer:
    def __init__(self, spans):
        self.intervals = spans

    def spans(self, name):
        return np.array(self.intervals.get(name, ()), dtype=np.int64).reshape(-1, 2)


def test_merger_spans_are_summed_by_the_sweep_they_precede():
    from harness import replays

    rec = _record(ROWS[:3])
    rec["host_ns"][:, 0] = [90 * MS, 101 * MS, 112 * MS]     # the calls, on the host's clock
    timer = _Timer({
        "merger.observe": [(85 * MS, 86 * MS), (95 * MS, 96 * MS), (96 * MS, 97 * MS), (105 * MS, 106 * MS)],
        "merger.merge": [(97 * MS, 100 * MS), (106 * MS, 110 * MS), (113 * MS, 114 * MS)],
        "other.span": [(92 * MS, 99 * MS)],
    })
    # before the first call: not a sweep of the record; after the last: not yet one
    np.testing.assert_allclose(replays.merger_ms(rec, timer), [5, 5])


def test_the_mean_pools_every_record(monkeypatch):
    from harness import replays

    monkeypatch.setattr(replays, "records", lambda upto: [_record(ROWS), _record(ROWS[:1])])
    assert replays.mean_ms(replays.graph_ms, {}) == pytest.approx(6.0)
    monkeypatch.setattr(replays, "records", lambda upto: [])
    assert replays.mean_ms(replays.graph_ms, {}) is None


def test_only_the_replays_before_the_profiler_are_read(monkeypatch):
    """A traced run of the replay driver replays the warm pass, then the
    window's first pass up to `trace_first`, before its profiler starts:
    those replays are read, and a ring that wrapped past them is not."""
    from harness import replays
    from locus_tpu_torch.ops import graph

    ctx = {"traffic": {"sweeps_per_pass": 2, "trace_first": 1, "trace_sweeps": 1}}
    assert replays.before_profiler(ctx) == 3 and replays.before_profiler({"traffic": {}}) is None
    monkeypatch.setattr(graph, "replay_records", lambda: [_record(ROWS)])
    np.testing.assert_allclose(replays.graph_ms(replays.records(3)[0]), [6, 7, 5])
    assert replays.mean_ms(replays.graph_ms, ctx) == pytest.approx(6.0)
    assert replays.mean_ms(replays.gap_ms, ctx) == pytest.approx(1.5)
    assert replays.mean_ms(replays.graph_ms, {}) == pytest.approx(6.0)
    monkeypatch.setattr(graph, "replay_records", lambda: [_record(ROWS, replays=9)])
    assert replays.records(3) == [] and replays.mean_ms(replays.graph_ms, ctx) is None


@pytest.mark.parametrize("cell", ["spot.replay", "husky.replay"])
def test_the_new_readers_find_nothing_on_the_cpu(cell):
    import run
    from harness import cells

    result, _ = run.run_cell(ROOT, cell, SEED, 0.1, True, device="cpu", overrides=tiny(cell))
    assert not set(NEW) & set(result["metrics"])
    for name in NEW:
        assert cells.reader(ROOT, name)({"sweeps": 1, "device": [], "host": []}, {"cell": cell}) is None
    json.dumps(result)


def test_the_new_metrics_are_entries_of_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert (m["unit"], m["better"], m["moves"]) == ("ms/scan", "lower", "scans_per_s")
        cells_ = ["husky.replay"] if name.startswith("merger.") else ["spot.replay", "husky.replay"]
        assert m["workloads"] == cells_
        assert m["source"] == ("program_span" if name.startswith("merger.") else "program_counter")
