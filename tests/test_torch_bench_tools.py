"""The port's benchmark tools on the CPU, against the JAX package:
tools/torch_bench.py, tools/torch_memory_report.py and
tools/torch_nn_bench.py; and every new tool's refusal to run without a
card unless given --device cpu.

Tolerances:
- bench: the line carries every field of bench.py's but `platform`, and its
  ATE lies within 1e-2 m of the JAX package's `make_scan_replay` on the
  same fallback sequence (the tolerance of the port's replays,
  tests/test_torch_pipeline.py);
- memory report: the bytes of every top-level field equal the JAX tool's
  grouping of `pipeline.init_state`, exactly, except the known layout
  difference: the map's 1-NN operand is (8, m) f32 in JAX and (m, 4) f32 in
  the port;
- nn bench (the plain path, map_kf 2): d2 within 1e-5 m^2 of JAX's
  `nearest_pallas_bounded_pre` in interpret mode and indices equal except
  where the two winners tie within that (tests/test_torch_nn.py's rule);
  the visit counts equal a box test of the port's 64-query tiles against
  JAX's `chunk_boxes`, exactly."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import pipeline as jpl
from locus_tpu import runner as jrunner
from locus_tpu.config import FilterConfig, LocusConfig, MapperConfig
from locus_tpu.io.dataset import make_tunnel_sequence as jtunnel
from locus_tpu.ops.pallas import nn as jnn
from locus_tpu_torch import pipeline as tpl
from locus_tpu_torch.convert import config_from_dict
from tests.torch_helpers import load_tool

CPU = torch.device("cpu")
ATE_TOL_M = 1e-2
D2_ATOL = 1e-5
BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "estimator", "best", "mad", "rates", "ate_m", "scans",
                "map_capacity", "scan_capacity")
NEW_TOOLS = ("torch_bench", "torch_eval_suite", "torch_latency_bench", "torch_profiler", "torch_memory_report",
             "torch_nn_bench", "torch_scaling_bench", "torch_collective_budget", "torch_exp_ablate", "torch_exp_gap",
             "torch_exp_gap2", "torch_exp_inner", "torch_exp_steady")


def _jax_production_config():
    """bench.py:38-48."""
    return LocusConfig(
        scan_capacity=4096, raw_scan_capacity=32768, points_to_process_in_callback=3000,
        filtering=FilterConfig(normals_k=20),
        mapper=MapperConfig(map_capacity=1 << 17, keyframe_capacity=4096, map_voxel_leaf=0.15),
    )


def _jax_fallback_config():
    """bench.py:49-59."""
    return LocusConfig(
        scan_capacity=1024, raw_scan_capacity=8192, points_to_process_in_callback=800,
        filtering=FilterConfig(normals_k=12),
        mapper=MapperConfig(map_capacity=1 << 14, keyframe_capacity=1024, map_voxel_leaf=0.15),
    )


def test_bench_line_matches_bench_py(monkeypatch, capsys):
    tb = load_tool("torch_bench")
    monkeypatch.setattr("sys.argv", ["torch_bench.py", "--device", "cpu", "--reps", "1"])
    assert tb.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in BENCH_FIELDS:
        assert k in line, k
    assert "platform" not in line and line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["vs_baseline"] == pytest.approx(line["value"] / 10.0)
    assert line["estimator"] == "median_of_1" and line["scans"] == 12 and line["scan_capacity"] == 1024
    jcfg = _jax_fallback_config()
    assert dataclasses.asdict(config_from_dict(dataclasses.asdict(jcfg))) == dataclasses.asdict(
        tb._torch_tool.fallback_config())
    seq = jtunnel(num_scans=12, azimuth_steps=512, step=0.35, seed=0)
    st = jpl.init_state(jcfg, initial_pose=jnp.asarray(seq.gt_poses[0], jnp.float32))
    st = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), st)     # as bench.py: donated buffers
    _, (poses, _, _) = jrunner.make_scan_replay(jcfg)(st, jrunner.pack_sequence(seq, jcfg))
    poses = np.asarray(poses)
    j_ate = float(np.sqrt(np.mean(np.sum((poses[:, :3, 3] - seq.gt_poses[:12, :3, 3]) ** 2, axis=1))))
    assert abs(line["ate_m"] - j_ate) < ATE_TOL_M, (line["ate_m"], j_ate)


def test_memory_report_bytes_equal_the_jax_tools():
    mr = load_tool("torch_memory_report")
    jcfg = _jax_production_config()
    cfg = mr._torch_tool.production_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(config_from_dict(dataclasses.asdict(jcfg)))
    port = mr.report(cfg, CPU)
    jstate = jpl.init_state(jcfg)
    jax_groups = {
        field: sum(int(np.prod(np.shape(x))) * np.dtype(getattr(x, "dtype", np.float32)).itemsize
                   for x in jax.tree_util.tree_leaves(sub))
        for field, sub in jstate._asdict().items()
    }
    m_pad = tpl.init_state(cfg, device=CPU).map.nn_aug.shape[0]
    # the one layout difference: the map's 1-NN operand, (8, m) f32 against (m, 4) f32
    expected = dict(jax_groups, map=jax_groups["map"] - 8 * m_pad * 4 + m_pad * 4 * 4)
    assert port["state_bytes_by_field"] == expected
    assert port["state_total_bytes"] == sum(expected.values())
    assert port["transient_bytes"] == {"live_per_scan_upload": 32768 * 16 + 4 * (2 + 16 + 64 + 4 + 64),
                                       "replay_48_scan_window": 48 * (32768 * 13 + 4 * 150)}
    assert port["card_total_memory_bytes"] is None and port["map_slots_fit_beside_state"] is None


@pytest.mark.parametrize("bt", [512, 1024, 2048])
def test_nn_bench_plain_path_matches_jax(bt):
    nb = load_tool("torch_nn_bench")
    from locus_tpu_torch.ops.kernels import nn as tnn

    m_cap = 1 << 14
    map_full, mask, query = nb.ring_store(2, m_cap)
    row = nb.bench_operand(map_full, mask, query, bt, 1, CPU)
    assert row["bit_equal"] and row["near_exact"] and row["route"] == "plain"
    mq, msk, qd = (torch.from_numpy(a) for a in (map_full, mask, query))
    t_aug = tnn.build_nn_target(mq, bt=bt)
    c_min, c_max = tnn.chunk_boxes(mq, msk, t_aug.shape[0], bt=bt)
    _, d2, idx = tnn.nearest_bounded_scores(qd, t_aug, mq, c_min, c_max, nb.RADIUS, bt=bt)
    j_aug = jnn.build_nn_target(jnp.asarray(map_full), bt=bt)
    jmin, jmax = jnn.chunk_boxes(jnp.asarray(map_full), jnp.asarray(mask), j_aug.shape[1], bt=bt)
    jd2, jidx = jnn.nearest_pallas_bounded_pre(jnp.asarray(query), j_aug, jnp.asarray(map_full), jmin, jmax,
                                               nb.RADIUS, interpret=True, bt=bt)
    jd2, jidx, d2, idx = np.asarray(jd2), np.asarray(jidx), d2.numpy(), idx.numpy()
    np.testing.assert_array_equal(np.isfinite(d2), np.isfinite(jd2))
    fin = np.isfinite(jd2)
    np.testing.assert_allclose(d2[fin], jd2[fin], rtol=0, atol=D2_ATOL)
    differ = idx != jidx
    assert np.all(np.abs(d2[differ] - jd2[differ]) <= D2_ATOL)
    # the visit counts: the port's tiles against JAX's chunk boxes
    tiles = query.reshape(-1, tnn.BQ, 3)
    t_min, t_max = tiles.min(axis=1), tiles.max(axis=1)
    jmin, jmax = np.asarray(jmin), np.asarray(jmax)
    gap = np.maximum(np.maximum(jmin[None] - t_max[:, None], t_min[:, None] - jmax[None]), 0.0)
    cnt = (np.sum(gap * gap, axis=-1) <= np.float32(nb.RADIUS * nb.RADIUS)).sum(axis=1)
    assert row["visited_chunks"] == int(cnt.sum())
    assert row["visited_chunks_per_tile_max"] == int(cnt.max())
    assert row["visited_pairs"] == int(cnt.sum()) * tnn.BQ * bt
    assert row["share_of_chunks_visited"] == pytest.approx(cnt.sum() / (cnt.size * (m_cap // bt)))


def test_nn_bench_shards_and_voxel_hash_operand():
    nb = load_tool("torch_nn_bench")
    r = nb.nn_bench(2, [2048], 1, CPU, shards=2, m_cap=1 << 14)
    (row,) = r["rows"]
    assert row["bit_equal"] and len(row["per_shard"]) == 2
    assert sum(s["map_points"] for s in row["per_shard"]) == 2 * nb.KF_POINTS
    vh = nb.nn_bench(2, [2048], 1, CPU, operand="voxel_hash", m_cap=1 << 14)
    (vrow,) = vh["rows"]
    # hashed slots: every chunk spans the window, so every tile visits every chunk
    assert vrow["bit_equal"] and vrow["share_of_chunks_visited"] == 1.0


@pytest.mark.parametrize("name", NEW_TOOLS)
def test_tool_needs_a_card_unless_asked(name, monkeypatch):
    tool = load_tool(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", [f"{name}.py"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()
