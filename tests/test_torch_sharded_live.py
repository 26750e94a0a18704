"""The port's sharded serving (`live.LiveSession(mesh=)`, the pose-graph
backend's `optimize(mesh=)`, the per-shard re-anchor of a closure and the
sharded session checkpoint) on gloo ranks on the CPU, against unsharded
sessions: tests/test_parallel.py::test_live_session_sharded_matches_unsharded,
tests/test_live.py:264 and the sharded optimize of
tests/test_slam_integration.py on the port.

Tolerances:
- a sharded session against an unsharded one on the same scans: within
  1e-4 m (JAX's bound), reached bit for bit; after a loop closure the
  sharded solve sums its partials in another order, so those poses are
  held to the served run's ATE bound (0.1 m, tests/test_torch_live.py's
  scaled live test) and reported;
- the closure push-back on a sharded session: the pose and the gathered
  map equal the unsharded session's bit for bit (JAX: 1e-6 and 1e-5);
- a sharded session resumed from its checkpoint repeats the next pose bit
  for bit.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu_torch.backend import PoseGraphBackend
from locus_tpu_torch.config import FilterConfig, FusionConfig, LocusConfig, MapperConfig
from locus_tpu_torch.io.dataset import Sequence as TSequence
from locus_tpu_torch.live import LiveSession
from locus_tpu_torch.parallel import mesh as tmesh
from tests.torch_helpers import np_
from tests.torch_ranks import launch_cases, launch_tool

SINGLE_TOL_M = 1e-4
ATE_LIMIT_M = 0.1


def _tseq(seq):
    return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})


def _cfg():
    """tests/test_live.py:277-286's config."""
    return LocusConfig(
        scan_capacity=256, raw_scan_capacity=1024, points_to_process_in_callback=200,
        filtering=FilterConfig(normals_k=8),
        mapper=MapperConfig(map_capacity=4096, keyframe_capacity=256, map_voxel_leaf=0.1),
        fusion=FusionConfig(data_integration_mode=0), b_enable_computation_time_profiling=False,
    )


def test_live_session_sharded_matches_unsharded(tmp_path):
    """tests/test_parallel.py::test_live_session_sharded_matches_unsharded:
    4 scans served with the map split over 2 ranks, against an unsharded
    session."""
    res = launch_tool(tmp_path, 2, "--mode", "live", "--scans", 4, "--azimuth", 64, "--seed", 13)
    assert res["mesh"] == {"data": 1, "map": 2} and res["ranks_agree"]
    assert res["max_translation_err_m"] < SINGLE_TOL_M and res["max_pose_err_before_first_closure"] == 0.0


def test_live_apply_loop_closure_and_resume_sharded_match_unsharded(tmp_path):
    """tests/test_live.py::test_live_apply_loop_closure_sharded_matches_unsharded
    on the port (each shard re-anchored where it lies), and the sharded
    session checkpoint: a session resumed from it repeats the next pose."""
    seq = make_tunnel_sequence(num_scans=3, azimuth_steps=64, seed=17)
    corr = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    corr[:, 0, 3] = 0.25                                  # every keyframe +x
    corrected = seq.gt_poses[2].astype(np.float32).copy()
    corrected[0, 3] += 0.25
    path = tmp_path / "seq.npz"
    _tseq(seq).save(str(path))
    outs = launch_cases(tmp_path, "live_closure", 2, {"seq": np.asarray(str(path)), "corr": corr,
                                                       "corrected": corrected})

    ref = LiveSession(cfg=_cfg(), initial_pose=seq.gt_poses[0], device="cpu")
    poses = np.stack([ref.process_scan(float(seq.stamps[k]), seq.scans[k], seq.scan_valid[k])[0] for k in range(3)])
    ref.apply_loop_closure(corrected, corr)
    mask = np_(ref.state.map.cloud.mask)
    for out in outs:
        assert int(out["local_points"]) == 2048
        np.testing.assert_array_equal(out["poses"], poses)
        np.testing.assert_array_equal(out["pose_after"], np_(ref.state.loc.integrated))
        np.testing.assert_array_equal(out["mask"], mask)
        np.testing.assert_array_equal(out["xyz"], np_(ref.state.map.cloud.xyz))
        np.testing.assert_array_equal(out["resumed_pose"], poses[2])
        assert int(out["resumed_scan_count"]) == 3          # resumed at 2, one scan served
    assert np.allclose(np_(ref.state.loc.integrated)[0, 3], corrected[0, 3])


def test_sharded_serving_with_closures(tmp_path):
    """chip_smoke.py's sharded_live phase at CI shapes: a 2-lap, 60-scan
    circuit served by 2 ranks, the pose-graph backend on each closing loops
    with optimize(mesh=) and pushing them back through each shard's
    re-anchor; poses up to the first push-back equal the unsharded
    session's, the run keeps its ATE bound, and every rank serves the same
    poses."""
    circuit = chip_smoke.circuit_sequence(60, 360, workers=2)
    path = tmp_path / "circuit.npz"
    circuit.save(str(path))
    res = launch_tool(tmp_path, 2, "--mode", "live", "--closures", "--profile", "ci", "--seq", path, timeout=400)
    assert res["closures_pushed_back"] >= 1 and res["ranks_agree"], res
    assert res["max_translation_err_before_first_closure_m"] < SINGLE_TOL_M
    assert res["ate_m"] < ATE_LIMIT_M
    assert all(r["solves"] == r["closures_pushed_back"] for r in res["ranks"])


def test_sharded_serving_argument_checks():
    """`mesh=` that is not a mesh raises TypeError (the session and the
    backend's optimize), a map that does not tile over the mesh's map
    columns ValueError; the shard count stays fixed on a live session."""
    with pytest.raises(TypeError, match="Mesh"):
        LiveSession(cfg=_cfg(), mesh=object(), device="cpu")
    two = tmesh.Mesh(1, 2, 0, torch.device("cpu"), "gloo")
    cfg = _cfg().replace(mapper=dataclasses.replace(_cfg().mapper, map_capacity=2048))
    with pytest.raises(ValueError, match="multiple of"):
        LiveSession(cfg=cfg, mesh=two, device="cpu")
    sess = LiveSession(cfg=_cfg(), mesh=tmesh.make_mesh(1, device_type="cpu"), device="cpu")
    with pytest.raises(ValueError, match="num_shards"):
        sess.reconfigure({"mapper": {"num_shards": 2}})
    backend = PoseGraphBackend(device="cpu")
    for i in range(3):
        pose = np.eye(4)
        pose[0, 3] = i
        backend.add_keyframe(i * 0.1, pose)
    with pytest.raises(TypeError, match="Mesh"):
        backend.optimize(mesh="map")
