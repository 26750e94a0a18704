"""The port's rank tools on the CPU: tools/torch_scaling_bench.py and
tools/torch_collective_budget.py over 1 and 2 gloo ranks (processes of
tools/torch_dist_smoke.py through parallel.distributed.spawn_ranks, one
torch thread each, with a deadline).

Tolerances: none. The scaling bench's robots give the poses of the 1-rank
batched replay bit for bit at every rank count; the collective budget's
bytes computed from the gathered shapes equal the bytes its counting
wrapper saw, a scan and a rank, and the sharded replay equals the
unsharded one bit for bit."""
import torch

from tests import torch_helpers  # noqa: F401  (caps torch's threads)
from tests.torch_helpers import load_tool

CPU = torch.device("cpu")


def test_scaling_bench_poses_equal_the_one_rank_run(tmp_path):
    sb = load_tool("torch_scaling_bench")
    r = sb.scaling([1, 2], 3, 1, False, CPU, workdir=tmp_path, timeout_s=240, repeats=2)
    assert r["poses_equal_single_rank"] and set(r["results"]) == {"1", "2"} and r["repeats"] == 2
    for n, row in r["results"].items():
        assert row["poses_equal_single_rank"] and row["max_pose_err"] == 0.0, n
        assert row["robots"] == int(n) and [len(t) for t in row["ticks_per_s_per_rank"]] == [int(n)] * 2
        assert row["seq_scans_per_sec"] > 0 and len(row["seq_scans_per_sec_runs"]) == 2
        assert row["seq_scans_per_sec_spread"] >= 0 and row["efficiency_spread"] >= 0
    assert r["results"]["1"]["efficiency_runs"] == [1.0, 1.0] and r["results"]["1"]["efficiency"] == 1.0
    assert "not scaling across cards" in r["note"]


def test_collective_budget_computed_equals_counted(tmp_path):
    cb = load_tool("torch_collective_budget")
    two = cb.budget("tiny", 2, 3, 128, "cpu", "gloo", tmp_path / "two", timeout_s=240)
    assert two["computed_equals_counted"] and two["sharded_equals_single"]
    assert two["gathers_per_scan"] == 2
    assert two["sent_bytes_per_scan"] == 256 * 10 * 4 + 4
    assert two["per_scan_collective_bytes"] == 2 * two["sent_bytes_per_scan"]
    assert all(c["calls_per_step"] == 2.0 for c in two["counted"])
    assert all(n == 2.0 for n in two["collectives_per_scan_traced"])
    assert all(ms > 0 for ms in two["collective_ms_per_scan"])
    one = cb.budget("tiny", 1, 3, 128, "cpu", "gloo", tmp_path / "one", timeout_s=240)
    assert one["computed_equals_counted"] and one["per_scan_collective_bytes"] == 0
    assert one["counted"][0]["calls_per_step"] == 0
