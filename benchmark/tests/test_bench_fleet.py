"""The fleet's cell (`spot_fleet4.fleet`, driver `drivers/fleet.py`): a tiny
fleet on the CPU through the same entry as the chip's runs, its comparison
failing on one robot's moved pose, the bounds of the batched kernels B3
and B4 against hand counts, and the batched step's records as the fleet's
readers read them."""
from __future__ import annotations

import json

import numpy as np
import pytest

from bench_helpers import ROOT, SEED, tiny

CELL = "spot_fleet4.fleet"
SECONDS = 0.1     # one tiny pass
FLEET = ["fleet.graph_ms_per_tick", "fleet.s2s.device_ms_per_tick", "fleet.s2m.device_ms_per_tick",
         "fleet.frozen_trip_share", "b3_map_roofline", "b4_visits_roofline"]


def _tiny(robots=2):
    over = tiny(CELL)
    over["config"]["fleet"] = {"robots": robots}
    return over


def _moved(outputs, robot=1):
    """Sweep 3 of `robot` moved 0.5 m along x."""
    out = []
    for r, f, p, z in outputs:
        if r == robot:
            p = p.copy()
            p[3, 0, 3] += 0.5
        out.append((r, f, p, z))
    return out


def _swapped(outputs):
    """Robots 0 and 1 handed each other's answers."""
    mine = {r: (p, z) for r, _, p, z in outputs}
    return [(r, f, *mine[{0: 1, 1: 0}.get(r, r)]) for r, f, _, _ in outputs]


def _all_robot_0(outputs):
    """Every robot handed robot 0's answer."""
    first = {r: (p, z) for r, _, p, z in outputs}[0]
    return [(r, f, *first) for r, f, _, _ in outputs]


def _kept_outputs(monkeypatch, fault=None):
    """Wrap the check's gaps: keep the outputs it was given, and pass
    them through `fault` first."""
    from harness import check

    gaps, kept = check.gaps, []

    def spy(outputs, refs):
        kept.extend(outputs)
        return gaps(fault(outputs) if fault else outputs, refs)
    monkeypatch.setattr(check, "gaps", spy)
    return kept


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_fleet_is_correct_with_an_output_per_robot_per_pass(monkeypatch, traced):
    import run

    kept = _kept_outputs(monkeypatch)
    result, lines = run.run_cell(ROOT, CELL, SEED, SECONDS, traced, device="cpu", overrides=_tiny())
    assert result["correct"], result["check"]
    passes = len(kept) // 2
    assert passes >= 1 and [r for r, *_ in kept] == [0, 1] * passes
    assert all(f == 0 and p.shape == (8, 4, 4) and z.shape == (8,) for _, f, p, z in kept)
    assert result["attempted"] == passes * 2 * 8
    # the two robots drive tunnels of their own
    assert not np.allclose(kept[0][2], kept[1][2])
    if traced:
        # the loops' counters are kept in every mode; the stamps and the kernels are the card's
        assert set(FLEET) & set(result["metrics"]) == {"fleet.frozen_trip_share"}
        assert 0.0 <= result["metrics"]["fleet.frozen_trip_share"]["value"] < 100.0
    else:
        assert set(result["metrics"]) == {"scans_per_s", "setup_s"}
    assert lines[-1].startswith("check ")
    json.dumps(result)


def test_a_robots_moved_pose_fails_the_fleets_check(monkeypatch):
    import run

    _kept_outputs(monkeypatch, _moved)
    result, _ = run.run_cell(ROOT, CELL, SEED, SECONDS, False, device="cpu", overrides=_tiny())
    assert result["correct"] is False and result["failed"] > 0, result["check"]


@pytest.mark.parametrize("fault", [_swapped, _all_robot_0])
def test_a_robot_handed_another_robots_answer_fails_the_fleets_check(monkeypatch, fault):
    import run

    _kept_outputs(monkeypatch, fault)
    result, _ = run.run_cell(ROOT, CELL, SEED, SECONDS, False, device="cpu", overrides=_tiny())
    assert result["correct"] is False and result["failed"] > 0, result["check"]
    # off by the tunnels' spacing less two sways, not by a rounding
    assert result["check"]["pose_gap_m"]["value"] > 18.0, result["check"]


def test_the_fleets_control_is_not_correct():
    import control

    rec = control.control(ROOT, CELL, SEED, SECONDS, device="cpu", overrides=_tiny())
    assert rec["correct"] is False and rec["sweeps"] == 2 * 8, rec


def test_each_robot_has_a_tunnel_of_its_own():
    import torch

    from harness import cells

    c = cells.deep_merge(cells.cell(ROOT, cells.load(ROOT), CELL), _tiny(3))
    robots = cells.driver(ROOT, "fleet").traffic(c["config"], c["traffic"], SEED, SECONDS, torch.device("cpu"))
    assert len(robots) == 3 and all(len(sw) == 8 for sw in robots)
    assert len({float(sw.gt[0, 1, 3]) - 20.0 * r for r, sw in enumerate(robots)}) == 3      # each its own sway
    # side by side: every two robots at least 20 m less two sways apart at every sweep, their odometry too
    for a in range(3):
        for b in range(a + 1, 3):
            for key in ("gt", "odom_poses"):
                gap = np.linalg.norm(getattr(robots[a], key)[:, :3, 3] - getattr(robots[b], key)[:, :3, 3], axis=1)
                assert gap.min() > 18.0, (a, b, key)


def test_b3_and_b4_bounds_against_hand_counts():
    from harness import roofline, roofline_batched as rb

    members = [{"num_points": 3000, "b4_pairs": 2_000_000, "map_before": 50_000},
               {"num_points": 1000, "b4_pairs": 100, "map_before": 0}]
    # B4: ops 2,000,100 pairs x 24 at 67e12/s against 4,000 points x 52 B at 3.35e12 B/s
    assert rb.b4_bound_s(members) == pytest.approx(max(2_000_100 * 24 / 67e12, 4000 * 52 / 3.35e12))
    assert rb.b4_bound_s(members) == pytest.approx(2_000_100 * 24 / 67e12)
    assert rb.b4_bound_s(members[1:]) == pytest.approx(1000 * 52 / 3.35e12)       # few pairs: bytes bound
    # B3 on the map: 4,000 queries x 20 B and 50,000 map points x 12 B
    assert rb.b3_map_bound_s(members) == pytest.approx((4000 * 20 + 50_000 * 12) / 3.35e12)
    assert rb.b3_map_bound_s(members[:1]) == roofline.b2_bound_s(3000, 50_000)


def _trace(ticks):
    """A traced record of `ticks` (odom loops, loc loops, B3 launches): the
    tick's B4 launch at t, then its B3 launches, 1 us apart; each B4 2 us,
    the map launch 4 us, the others 1 us."""
    device, rows, t = [], [], 0.0
    for o, l, n in ticks:
        device.append(("void moments_visits_kernel<2>", t, t + 2e-6))
        for k in range(n):
            start = t + 3e-6 + 5e-6 * k
            device.append(("void nn_visits_kernel<1>", start, start + (4e-6 if k == o else 1e-6)))
        rows.append({"members": [{"num_points": 3000, "b4_pairs": 2_000_000, "map_before": 50_000}] * 2,
                     "odom_loops": o, "loc_loops": l, "odom_cap": 20, "loc_cap": 25})
        t += 1e-3
    return {"sweeps": 2 * len(ticks), "device": device, "host": [], "kernel_inputs": rows}


def test_b3_and_b4_shares_of_a_traced_fleet():
    from harness import roofline_batched as rb

    members = [{"num_points": 3000, "b4_pairs": 2_000_000, "map_before": 50_000}] * 2
    # tick 2 ran its scan-to-scan loop to the cap: its map launch is left out
    rec = _trace([(3, 5, 9), (4, 25, 31), (20, 6, 28)])
    assert rb.b4_share(rec) == pytest.approx(100 * rb.b4_bound_s(members) / 2e-6)
    assert rb.b3_map_share(rec) == pytest.approx(100 * rb.b3_map_bound_s(members) / 4e-6)
    assert rb.b4_share(dict(rec, kernel_inputs=rec["kernel_inputs"][:2])) is None     # launches and ticks disagree
    single = dict(rec, kernel_inputs=[{"num_points": 1} for _ in range(3)])            # the replay driver's rows
    assert rb.b4_share(single) is None and rb.b3_map_share(single) is None


def test_the_batched_records_are_read_by_their_step(monkeypatch):
    from harness import batched_records, replays

    from test_bench_replays import ROWS, _record

    mine, other = dict(_record(ROWS), step=batched_records.STEP), dict(_record(ROWS[:1]), step="runner.replay_step")
    other["device_ns"] = other["device_ns"] * 0 + 5     # a record the readers must not pool
    monkeypatch.setattr(replays, "records", lambda upto: [mine, other])
    assert batched_records.mean_ms(replays.graph_ms, {}) == pytest.approx(6.0)
    assert batched_records.mean_ms(lambda r: replays.stage_ms(r, "stage_b"), {}) == pytest.approx(3.25)
    monkeypatch.setattr(replays, "records", lambda upto: [other])
    assert batched_records.mean_ms(replays.graph_ms, {}) is None


def test_the_frozen_trip_share():
    from harness import batched_records

    counters = {"stage_s2s/gicp.member_trips_run": 40, "stage_s2s/gicp.member_trips_needed": 30,
                "stage_s2m/gicp.member_trips_run": 60, "stage_s2m/gicp.member_trips_needed": 50}
    assert batched_records.frozen_trip_share({"program_counters": counters}) == pytest.approx(20.0)
    assert batched_records.frozen_trip_share({"program_counters": {}}) is None
    assert batched_records.frozen_trip_share({"sweeps": 1, "device": [], "host": []}) is None


@pytest.mark.parametrize("name", FLEET)
def test_the_fleets_readers_find_nothing_in_a_single_replays_record(name):
    from harness import cells

    rec = {"sweeps": 1, "device": [], "host": [], "kernel_inputs": None}
    assert cells.reader(ROOT, name)(rec, {"cell": CELL, "traffic": {}}) is None


def test_the_fleets_metrics_are_entries_of_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in FLEET:
        m = entries[name]
        assert m["workloads"] == [CELL] and m["moves"] == "scans_per_s"
    scans = {m["name"]: m for m in bench["end_to_end"]}["scans_per_s"]
    assert scans["workloads"] == ["spot.replay", "husky.replay", CELL]
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("spot_fleet4", "fleet", 1)
