"""The port's replay tools on the CPU at small shapes, against the JAX
package: tools/torch_eval_suite.py, tools/torch_profiler.py,
tools/torch_latency_bench.py and tools/torch_simulate_sensor_drops.py.

Tolerances:
- eval suite, tunnel world: the ATE within 1e-2 m of the JAX package's
  `run_sequence` on the same `make_world_sequence` (the tolerance of the
  port's replays in tests/test_torch_pipeline.py). Loop world: replays
  with closures are chaotic between the packages (ROADMAP §C,
  tests/test_torch_slam.py), so its poses and closure count must equal
  the port's own `run_sequence(backend=)` on the same sequence, bit for
  bit;
- profiler and latency: the percentiles are ordered, and the latency
  decomposition sums to the p50 (to 1e-9 ms);
- sensor drops: the output .npz equals tools/simulate_sensor_drops.py's,
  array for array, exactly (the one place the tests run a JAX tool)."""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from locus_tpu import runner as jrunner
from locus_tpu.io.dataset import make_world_sequence as jworld
from locus_tpu.metrics import ate_rmse as jate
from locus_tpu_torch import runner as trunner
from locus_tpu_torch.backend import PoseGraphBackend
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.io.dataset import Sequence, make_tunnel_sequence, make_world_sequence
from tests.test_pipeline import small_cfg
from tests.torch_helpers import load_tool

CPU = torch.device("cpu")
ATE_TOL_M = 1e-2
JCFG = small_cfg()
TCFG = config_from_dict(dataclasses.asdict(JCFG))


def test_eval_suite_tunnel_matches_jax():
    ev = load_tool("torch_eval_suite")
    rows = ev.evaluate(ev.eval_config(base=TCFG), 12, 256, CPU, worlds=("tunnel",))
    seq = jworld("tunnel", num_scans=12, azimuth_steps=256)
    jp, _, _ = jrunner.run_sequence(seq, JCFG, collect_outputs=False)
    j_ate = jate(jp[:, :3, 3], seq.gt_poses[:12, :3, 3], align=False)
    assert abs(rows["tunnel"]["ate_m"] - j_ate) < ATE_TOL_M, (rows["tunnel"]["ate_m"], j_ate)
    assert rows["tunnel"]["distance_m"] == pytest.approx(12 * 0.35)
    out = ev.with_reference(rows, *ev.reference_rows())
    assert out["reference"] == "EVAL_r05.json"
    assert rows["tunnel"]["ate_gap_to_jax_m"] == pytest.approx(rows["tunnel"]["ate_m"] - 0.0137)


def test_eval_suite_loop_world_is_the_ports_slam_replay():
    ev = load_tool("torch_eval_suite")
    seq = make_world_sequence("loop", num_scans=24, azimuth_steps=256)
    cfg = ev.eval_config(base=TCFG)
    poses, closures = ev.replay_world(cfg, seq, "loop", CPU)
    backend = PoseGraphBackend(device=CPU, loop_distance=2.5, min_index_gap=8, loop_fitness_max=0.12)
    ref, _, _ = trunner.run_sequence(seq, cfg, collect_outputs=False, backend=backend, device=CPU)
    np.testing.assert_array_equal(poses, ref)
    assert closures == backend.loops_found >= 1


@pytest.mark.parametrize("mode, source", [
    (dict(method="ndt"), "EVAL_NDT_r05.json:ndt_direct7_1.0m"),
    (dict(method="ndt", ndt_neighborhood="kdtree", ndt_resolution=0.5), "EVAL_NDT_r05.json:ndt_kdtree_0.5m"),
    (dict(features=True), "EVAL_FEATURES_r05.json"),
])
def test_eval_suite_modes_configure_both_stages(mode, source):
    ev = load_tool("torch_eval_suite")
    cfg = ev.eval_config(**mode, azimuth=900)
    for stage in (cfg.odometry, cfg.localization.registration):
        assert stage.registration_method == mode.get("method", "gicp")
        if "ndt_resolution" in mode:
            assert (stage.ndt_resolution, stage.ndt_neighborhood) == (0.5, "kdtree")
        assert stage.covariance_mode == ("adaptive" if mode.get("features") else "normals")
    assert cfg.filtering.extract_features == bool(mode.get("features"))
    name, rows = ev.reference_rows(**mode)
    assert name == source and set(rows) == {"tunnel", "urban", "cave", "loop"}


def test_profiler_percentiles_are_ordered():
    pr = load_tool("torch_profiler")
    seq = make_tunnel_sequence(num_scans=4, azimuth_steps=256, step=0.3, seed=1)
    s = pr.profile(TCFG, seq, 4, CPU)
    assert s["count"] == 4 and s["rate_hz"] > 0
    assert 0 < s["p50_s"] <= s["p90_s"] <= s["p95_s"] <= s["p99_s"] <= s["max_s"]
    assert np.isfinite(s["ate_m"]) and s["final_map_size"] > 0 and s["keyframes"] >= 1


def test_latency_decomposition_sums_to_the_p50():
    lb = load_tool("torch_latency_bench")
    r = lb.latency(TCFG, 6, 256, CPU)
    assert r["scans"] == 4 and len(r["latency_ms_per_scan"]) == 4
    assert 0 < r["p50_ms"] <= r["p90_ms"] <= r["p99_ms"] <= r["max_ms"]
    a = r["attribution"]
    assert all(a[k] > 0 for k in ("payload_floor_ms", "device_compute_per_scan_ms", "host_packing_ms"))
    assert sum(a.values()) == pytest.approx(r["p50_ms"], abs=1e-9)


def _load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sensor_drops_match_the_jax_tool(tmp_path, monkeypatch):
    tools = Path(__file__).resolve().parent.parent / "tools"
    src = tmp_path / "in.npz"
    make_tunnel_sequence(num_scans=20, azimuth_steps=64, seed=3).save(str(src))
    gaps = ["--odom-gaps", "0.2:0.5", "1.1:1.3", "--imu-gaps", "0.7:0.95"]
    monkeypatch.syspath_prepend(str(tools))
    jtool = _load_by_path("jax_simulate_sensor_drops", tools / "simulate_sensor_drops.py")
    for tool, out in ((jtool, "jax.npz"), (load_tool("torch_simulate_sensor_drops"), "port.npz")):
        monkeypatch.setattr(sys, "argv", ["tool", str(src), str(tmp_path / out), *gaps])
        tool.main()
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    port = Sequence.load(str(tmp_path / "port.npz"))
    assert len(port.odom_stamps) < 20 and len(port.imu_stamps) < 200
