"""The port's replay experiments on the CPU, (c) of
tests/test_torch_exp_tools.py for tools/torch_exp_gap2.py,
torch_exp_steady.py and torch_exp_inner.py: each runs through `main` with
--device cpu for a few scans and one rep, prints the JAX tool's keys, and
its default poses (the default config's replay from a fresh state) equal
`runner.run_sequence`'s on the same scans bit for bit; and
tools/torch_exp_spread.py's quartiles over calls."""
import pytest

from locus_tpu_torch.io.dataset import make_world_sequence
from tests.test_torch_exp_tools import assert_default_poses, run_main, tunnel
from tests.torch_helpers import load_tool


def test_exp_gap2_main(monkeypatch, capsys):
    tool, line = run_main("torch_exp_gap2", ["--scans", 4, "--reps", 1], monkeypatch, capsys)
    assert line["warm_map_size"] > 0 and line["warm_kf"] >= 1
    for name in tool.VARIANTS:
        row = line[name]
        assert row["scans_per_s"] == max(row["rates"]) and row["kf_inserted"] >= 0
    assert line["warm_no_kf"]["kf_inserted"] == 0
    assert line["warm_window"] == [0, 2] and line["timed_window"] == [2, 4]
    assert_default_poses(tool, line, tunnel(tool.SEQ_SCANS), 2)


def test_exp_steady_main(monkeypatch, capsys):
    tool, line = run_main("torch_exp_steady", ["--scans", 9, "--reps", 1], monkeypatch, capsys)
    assert list(tool.windows(9)) == ["fresh3", "steady2", "fresh9", "steady8"]
    for key in tool.windows(9):
        assert line[key] == line["rows"][key]["scans_per_s"] > 0
    assert_default_poses(tool, line, tunnel(tool.SEQ_SCANS), 3)


def test_exp_inner_main(monkeypatch, capsys):
    tool, line = run_main("torch_exp_inner", ["--scans", 2, "--world-scans", 2, "--reps", 1], monkeypatch, capsys)
    for key in ("inner3", "inner2"):
        row = line[key]
        assert set(row) >= {"ate_tunnel", "ate_urban", "ate_cave", "scans_per_s", "ate_bench"}
        assert "ate_garage" not in row
        assert row["scans_per_s"] == max(row["rates"])
    world = make_world_sequence("tunnel", num_scans=tool.WORLD_SCANS, azimuth_steps=512)
    assert_default_poses(tool, line, world, 2)


def _record(rates: dict, top_level=False, device="cpu"):
    rows = {name: {"rates": r} for name, r in rates.items()}
    return (rows if top_level else {"rows": rows}) | {"device": device, "power_limit_w": None}


def test_spread_reports_the_quartiles_over_calls():
    tool = load_tool("torch_exp_spread")
    calls = [{"base": [10, 11, 12], "fast": [20, 22, 24]}, {"base": [10, 10, 10], "fast": [15, 15, 15]},
             {"base": [12, 12, 12], "fast": [24, 24, 24]}]
    for top_level in (False, True):             # exp_ablate's `rows`, exp_gap's top-level rows
        res = tool.spread([_record(c, top_level) for c in calls])
        assert res["base"] == "base" and res["calls"] == 3 and res["device"] == "cpu"
        assert res["variants"]["base"]["ratios"] == [1.0, 1.0, 1.0]
        fast = res["variants"]["fast"]
        assert fast["ratios"] == pytest.approx([2.0, 1.5, 2.0])
        assert fast["ratio_quartiles"] == pytest.approx([1.75, 2.0, 2.0])
        assert fast["share_quartiles"] == pytest.approx([5 / 12, 0.5, 0.5])   # shares 0.5, 1/3, 0.5
    with pytest.raises(SystemExit, match="different cards"):
        tool.spread([_record(calls[0]), _record(calls[1], device="NVIDIA H100")])
