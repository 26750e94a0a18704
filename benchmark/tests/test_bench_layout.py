"""BENCHMARK.json keeps to its contract's shape, and a cell made of newly
added files alone (a configuration, a traffic mix, a per-layer metric, a
reference, the limits of its comparison) is found and run with no edit to
any file."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_helpers import BENCH, ROOT, SEED, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and (BENCH / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"], (m["name"], w)
    pairs = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists() and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reported = [m for m in bench["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


def _copy(root):
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _add_cell(root):
    """A copy of the benchmark under `root`, with one new configuration,
    mix, metric and limits file, and their entries."""
    bench = _copy(root)
    conf = json.loads((BENCH / "configs" / "spot.json").read_text())
    conf["name"] = "newbot"
    conf["robot"]["step_m"] = 0.12
    (root / "benchmark" / "configs" / "newbot.json").write_text(json.dumps(conf))
    mix = json.loads((BENCH / "traffic" / "replay.json").read_text())
    mix["sweeps_per_pass"] = 120
    (root / "benchmark" / "traffic" / "newmix.json").write_text(json.dumps(mix))
    (root / "benchmark" / "metrics" / "new.host_spans_per_sweep.py").write_text(
        "def read(rec, ctx):\n    return len(rec['host']) / rec['sweeps']\n")
    limits = json.loads((BENCH / "limits" / "spot.replay.json").read_text())
    (root / "benchmark" / "limits" / "newbot.newmix.json").write_text(json.dumps(limits))
    bench["configs"].append({"name": "newbot", "source": "a test", "file": "benchmark/configs/newbot.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "newbot.newmix", "config": "newbot", "traffic": "newmix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("newbot.newmix")
    bench["per_layer"].append({"name": "new.host_spans_per_sweep", "unit": "spans/sweep", "better": "lower",
                               "source": "program_span", "layer": "device", "moves": "scans_per_s",
                               "workloads": ["newbot.newmix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_cell_of_new_files_alone_runs(tmp_path):
    from harness import cells

    import run

    _add_cell(tmp_path)
    bench = cells.load(tmp_path)
    c = cells.cell(tmp_path, bench, "newbot.newmix")
    assert c["config"]["robot"]["step_m"] == 0.12 and c["traffic"]["sweeps_per_pass"] == 120
    assert [m["name"] for m in cells.metrics(bench, "per_layer", "newbot.newmix")] == ["new.host_spans_per_sweep"]
    result, lines = run.run_cell(tmp_path, "newbot.newmix", SEED, 0.1, True, device="cpu", overrides=tiny("spot"))
    assert "new.host_spans_per_sweep" in result["metrics"]
    assert lines[-1].startswith("check ")


# A driver of two robots, each replayed in turn by the replay driver, with
# an end-to-end metric of its own: what a fleet's driver adds as new files.
PAIR_DRIVER = '''
from drivers import replay
from harness.program import Window, one_robot


def traffic(conf, mix, seed, seconds, dev):
    return one_robot(conf, mix, seed, dev) + one_robot(conf, mix, seed + 1, dev)


class Driver:
    def __init__(self, cfg, conf, mix, robots, dev):
        self.each = [replay.Driver(cfg, conf, mix, [sw], dev) for sw in robots]

    def setup(self):
        for d in self.each:
            d.setup()

    def window(self, seconds, traced):
        w = Window()
        for r, d in enumerate(self.each):
            part = d.window(seconds / len(self.each), traced)
            w.outputs += [(r,) + o[1:] for o in part.outputs]
            w.sweeps += part.sweeps
            w.elapsed_s += part.elapsed_s
            w.trace = w.trace or part.trace
        w.values["robot_ms_per_scan"] = 1e3 * w.elapsed_s / w.sweeps
        return w
'''


@pytest.mark.parametrize("fault", [False, True])
def test_a_driver_and_an_end_to_end_metric_of_new_files_alone_run(tmp_path, monkeypatch, fault):
    """A new driver file, a mix naming it, a new end-to-end metric and a
    cell: run with no edit to any file, every robot checked (the second
    robot's poses moved by 0.5 m come out not correct)."""
    import run
    from harness import check

    bench = _copy(tmp_path)
    (tmp_path / "benchmark" / "drivers" / "pair.py").write_text(PAIR_DRIVER)
    mix = json.loads((BENCH / "traffic" / "replay.json").read_text())
    mix["driver"] = "pair"
    (tmp_path / "benchmark" / "traffic" / "pair.json").write_text(json.dumps(mix))
    shutil.copy(BENCH / "limits" / "spot.replay.json", tmp_path / "benchmark" / "limits" / "spot.pair.json")
    bench["workloads"].append({"name": "spot.pair", "config": "spot", "traffic": "pair", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "robot_ms_per_scan", "unit": "ms/scan", "better": "lower", "bound": 0.1,
                                "source": "host_clock", "workloads": ["spot.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    if fault:
        gaps = check.gaps

        def moved(outputs, refs):
            out = []
            for r, f, p, z in outputs:
                p = p.copy()
                p[3, 0, 3] += 0.5 * (r == 1)
                out.append((r, f, p, z))
            return gaps(out, refs)
        monkeypatch.setattr(check, "gaps", moved)
    result, _ = run.run_cell(tmp_path, "spot.pair", SEED, 0.1, False, device="cpu", overrides=tiny("spot"))
    assert set(result["metrics"]) == {"robot_ms_per_scan", "setup_s"}
    assert result["metrics"]["robot_ms_per_scan"]["value"] > 0
    assert result["attempted"] == 2 * 8
    assert result["correct"] is (not fault), result["check"]


# A plain reference of new files alone: locus_ref's front end, with the
# result of its registration (scan-to-scan and scan-to-submap) moved along x.
SHIFTED_REF = '''
from reference import locus_ref


class Shifted(locus_ref.Reference):
    def register(self, src, src_n, tgt, tgt_n, guess, reg):
        T = super().register(src, src_n, tgt, tgt_n, guess, reg).clone()
        T[0, 3] += {shift}
        return T


def replay(*args, **kwargs):
    return locus_ref.replay(*args, cls=Shifted, **kwargs)
'''


def _add_reference(root, shift: float):
    """A copy of the benchmark under `root` with a reference, a
    configuration that names it (spot's otherwise) and its cell, all new
    files and entries."""
    bench = _copy(root)
    (root / "benchmark" / "reference" / "shifted_ref.py").write_text(SHIFTED_REF.format(shift=shift))
    conf = json.loads((BENCH / "configs" / "spot.json").read_text())
    conf["name"], conf["reference"] = "shifted", "shifted_ref"
    (root / "benchmark" / "configs" / "shifted.json").write_text(json.dumps(conf))
    shutil.copy(BENCH / "limits" / "spot.replay.json", root / "benchmark" / "limits" / "shifted.replay.json")
    bench["configs"].append({"name": "shifted", "source": "a test", "file": "benchmark/configs/shifted.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "shifted.replay", "config": "shifted", "traffic": "replay", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("shifted.replay")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_a_reference_of_new_files_alone_checks_its_cell(tmp_path, shift):
    """The cell is judged against the reference its configuration names:
    the program comes out correct against locus_ref's registration moved
    by nothing, and not correct against it moved by 0.5 m."""
    import run

    _add_reference(tmp_path, shift)
    result, _ = run.run_cell(tmp_path, "shifted.replay", SEED, 0.1, False, device="cpu", overrides=tiny("spot"))
    assert result["correct"] is (shift == 0.0), result["check"]
    if shift:
        assert result["failed"] > 0


def test_naming_locus_ref_gives_the_check_values_of_the_default():
    import run

    over = tiny("spot.replay")
    named = dict(over, config=dict(over["config"], reference="locus_ref"))
    default, _ = run.run_cell(ROOT, "spot.replay", SEED, 0.1, False, device="cpu", overrides=over)
    explicit, _ = run.run_cell(ROOT, "spot.replay", SEED, 0.1, False, device="cpu", overrides=named)
    assert explicit["check"] == default["check"]
    assert (explicit["correct"], explicit["attempted"], explicit["failed"]) == (
        default["correct"], default["attempted"], default["failed"])


def test_the_control_runs_the_named_reference_at_bfloat16(tmp_path, monkeypatch):
    import torch

    import control
    from harness import cells

    _add_reference(tmp_path, 0.5)
    calls = []
    load = cells.reference

    def spied(root, name):
        mod = load(root, name)
        replay = mod.replay

        def recorded(*args, dtype=torch.float64, **kwargs):
            calls.append((name, dtype))
            return replay(*args, dtype=dtype, **kwargs)
        mod.replay = recorded
        return mod

    monkeypatch.setattr(cells, "reference", spied)
    rec = control.control(tmp_path, "shifted.replay", SEED, 0.1, device="cpu", overrides=tiny("spot"))
    assert calls == [("shifted_ref", torch.float64), ("shifted_ref", torch.bfloat16)]
    assert rec["correct"] is False, rec
