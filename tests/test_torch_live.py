"""The port's live serving (`locus_tpu_torch/live.py::LiveSession`, the live
step of `runner.make_live_step`) against the JAX package's LiveSession:
the cases of tests/test_live.py on the same scans and sensor samples.

Tolerances: poses against JAX within 1e-2 m (the replay tolerance of
tests/test_torch_pipeline.py: f32 noise that scan-to-submap GICP may grow
over a few scans); the port against itself (a resumed session, the live
step against the replay step) bit for bit, as the CPU port is
deterministic. The JAX file's sharded case (test_live.py:264) has no
counterpart: LiveSession(mesh=) is ROADMAP A16 and raises. Its endurance
leg (test_live.py:339, tools/live_endurance.py --ci) becomes
`test_live_serving_endurance_scaled`, chip_smoke.py's live phase at CI
shapes on the CPU.
"""
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu.live import LiveSession as JLive
from locus_tpu_torch import native, pipeline, runner
from locus_tpu_torch import config as tconfig
from locus_tpu_torch.convert import config_from_dict, state_from_checkpoint
from locus_tpu_torch.io.dataset import Sequence as TSequence
from locus_tpu_torch.live import LiveSession
from locus_tpu_torch.metrics import ate_rmse
from locus_tpu_torch.ops.kernels import build, nn as tnn
from locus_tpu_torch.publisher import FixedRatePublisher
from tests.test_live import small_cfg
from tests.torch_helpers import pose_diff

POSE_TOL_M = POSE_TOL_RAD = 1e-2
RESUME_EVERY = 5


def _tcfg(jcfg=None):
    return config_from_dict(dataclasses.asdict(jcfg or small_cfg()))


@pytest.fixture(scope="module")
def seq():
    return make_tunnel_sequence(num_scans=8, azimuth_steps=256, step=0.3, seed=2)


def _imu_feed(seq):
    """The IMU samples fed ahead of each scan (tests/test_live.py:34-50)."""
    end = np.searchsorted(seq.imu_stamps, seq.stamps, side="right")
    return [range(end[i - 1] if i else 0, end[i]) for i in range(len(seq))]


def _serve(sess, seq, scans, feed=True):
    poses, outs = [], []
    for i in scans:
        if feed:
            for k in _imu_feed(seq)[i]:
                sess.feed_imu(seq.imu_stamps[k], seq.imu_quats[k])
        pose, out = sess.process_scan(seq.stamps[i], seq.scans[i], seq.scan_valid[i])
        poses.append(pose)
        outs.append(out)
    return np.stack(poses), outs


def _assert_close(tp, jp):
    for i, (a, b) in enumerate(zip(tp, jp)):
        dt, dr = pose_diff(a, b)
        assert dt < POSE_TOL_M and dr < POSE_TOL_RAD, (i, dt, dr)


@pytest.fixture(scope="module")
def jax_session(seq, tmp_path_factory):
    """JAX's session over the 8 scans with the IMU fed, checkpointing once
    (after scan RESUME_EVERY)."""
    ck = str(tmp_path_factory.mktemp("jax_live") / "live.npz")
    sess = JLive(cfg=small_cfg(), initial_pose=seq.gt_poses[0], checkpoint_path=ck, checkpoint_every=RESUME_EVERY)
    poses, outs = _serve(sess, seq, range(8))
    return poses, outs, ck


def scan_stream(seq, n):
    for i in range(n):
        yield seq.stamps[i], seq.scans[i], seq.scan_valid[i]


def test_live_session_tracks_like_jax(seq, jax_session):
    sess = LiveSession(cfg=_tcfg(), initial_pose=seq.gt_poses[0], device="cpu")
    poses, outs = _serve(sess, seq, range(8))
    jposes, jouts, _ = jax_session
    _assert_close(poses, jposes)
    assert [o.keyframe_inserted for o in outs] == [o.keyframe_inserted for o in jouts]
    assert [int(o.prior_source) for o in outs] == [int(o.prior_source) for o in jouts]
    assert np.linalg.norm(poses[-1][:3, 3] - seq.gt_poses[7][:3, 3]) < 0.15
    assert sess.diag.summary()["count"] == 8
    assert sess.timer.summary()["lidar_callback"]["count"] == 8


def test_live_publisher_integration(seq):
    pub = FixedRatePublisher(rate_hz=20.0)
    sess = LiveSession(cfg=_tcfg(), initial_pose=seq.gt_poses[0], publisher=pub, device="cpu")
    sess.run(scan_stream(seq, 5))
    # 5 scans over 0.4 s at 20 Hz
    assert len(pub.published) >= 5
    np.testing.assert_array_equal(pub.latest_scan_pose, sess.state.loc.integrated.numpy())


def test_live_checkpoint_resume_is_bit_exact(tmp_path, seq):
    ck = str(tmp_path / "live.npz")
    straight = LiveSession(cfg=_tcfg(), initial_pose=seq.gt_poses[0], checkpoint_path=ck, checkpoint_every=3,
                           device="cpu")
    _serve(straight, seq, range(3), feed=False)     # the checkpoint fires after scan 2 (count 3)
    os.replace(ck, tmp_path / "at3.npz")
    poses, _ = _serve(straight, seq, range(3, 6), feed=False)
    resumed = LiveSession(cfg=_tcfg(), initial_pose=seq.gt_poses[0], device="cpu")
    resumed.resume(str(tmp_path / "at3.npz"))
    assert resumed._scan_count == 3
    again, _ = _serve(resumed, seq, range(3, 6), feed=False)
    np.testing.assert_array_equal(again, poses)
    assert np.linalg.norm(again[-1][:3, 3] - seq.gt_poses[5][:3, 3]) < 0.2


def test_live_resumes_from_a_jax_checkpoint(seq, jax_session):
    """A session resumed in the port where JAX's stopped: the next scans
    match JAX's."""
    jposes, _, ck = jax_session
    sess = LiveSession(cfg=_tcfg(), initial_pose=seq.gt_poses[0], device="cpu")
    sess.state = state_from_checkpoint(ck, sess.cfg, "cpu")
    sess._scan_count = RESUME_EVERY
    poses, _ = _serve(sess, seq, range(RESUME_EVERY, 8))
    _assert_close(poses, jposes[RESUME_EVERY:])


def test_live_debug_dumps(tmp_path, seq):
    sess = LiveSession(cfg=_tcfg(), initial_pose=seq.gt_poses[0], debug_dump_dir=str(tmp_path / "dumps"),
                       debug_dump_every=2, device="cpu")
    sess.run(scan_stream(seq, 4))
    files = sorted(os.listdir(tmp_path / "dumps"))
    assert files == ["map_000002.pcd", "map_000004.pcd", "scan_000002.pcd", "scan_000004.pcd"]


def test_live_reconfigure(seq):
    """Parameters that shape no state change on a running session; the
    others raise."""
    sess = LiveSession(cfg=_tcfg(), initial_pose=seq.gt_poses[0], device="cpu")
    sess.run(scan_stream(seq, 3))
    sess.reconfigure({"filtering": {"box_max": [0.8, 0.8, 0.8]}, "odometry": {"corr_dist": 0.8}})
    assert sess.cfg.filtering.box_max == (0.8, 0.8, 0.8) and sess.cfg.odometry.corr_dist == 0.8
    poses = sess.run((seq.stamps[i], seq.scans[i], seq.scan_valid[i]) for i in range(3, 8))
    assert np.linalg.norm(poses[-1][:3, 3] - seq.gt_poses[7][:3, 3]) < 0.2
    with pytest.raises(ValueError, match="map_capacity"):
        sess.reconfigure({"mapper": {"map_capacity": 1 << 14}})
    with pytest.raises(ValueError, match="scan_capacity"):
        sess.reconfigure({"scan_capacity": 2048})


def test_live_set_voxel_leaf_and_pose(seq):
    """change_leaf_size and SetIntegratedEstimate on a running session."""
    cfg = _tcfg().replace(b_adaptive_input_voxelization=False)
    sess = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0], device="cpu")
    sess.process_scan(seq.stamps[0], seq.scans[0], seq.scan_valid[0])
    sess.set_voxel_leaf(0.5)
    _, coarse = sess.process_scan(seq.stamps[1], seq.scans[1], seq.scan_valid[1])
    assert float(coarse.voxel_leaf) == pytest.approx(0.5)
    sess.set_voxel_leaf(0.05)
    _, fine = sess.process_scan(seq.stamps[2], seq.scans[2], seq.scan_valid[2])
    assert float(fine.voxel_leaf) == pytest.approx(0.05)
    assert int(coarse.num_points) < int(fine.num_points)
    jump = np.array(seq.gt_poses[3], np.float32)
    jump[:3, 3] += np.array([50.0, 0.0, 0.0], np.float32)
    sess.set_pose(jump)
    pose, _ = sess.process_scan(seq.stamps[3], seq.scans[3], seq.scan_valid[3])
    assert np.linalg.norm(pose[:3, 3] - jump[:3, 3]) < 1.0


def test_live_host_prevoxelize_matches_jax(seq):
    """Scans voxelised on the host at half the adaptive leaf (the
    reference's upstream CustomVoxelGrid) by the native library: the port
    tracks as JAX does on the same library."""
    results, port_poses = {}, {}
    for pre in (False, True):
        sess = LiveSession(_tcfg(), host_prevoxelize=pre, device="cpu")
        port_poses[pre], outs = _serve(sess, seq, range(8), feed=False)
        results[pre] = ate_rmse(port_poses[pre][:, :3, 3], seq.gt_poses[:8, :3, 3], align=False)
    assert results[True] < 0.15 and results[False] < 0.15, results
    jposes, _ = _serve(JLive(small_cfg(), host_prevoxelize=True), seq, range(8), feed=False)
    _assert_close(port_poses[True], jposes)


def test_host_prevoxelize_never_falls_back(tmp_path, seq, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    sess = LiveSession(_tcfg(), host_prevoxelize=True, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        sess.process_scan(seq.stamps[0], seq.scans[0], seq.scan_valid[0])


def test_live_map_publish_cadence(seq):
    """map_publishment_meters: the map sink fires on every Nth keyframe."""
    cfg = _tcfg().replace(map_publishment_meters=1, translation_threshold_closed_space_kf=0.1,
                          rotation_threshold_closed_space_kf=0.05)
    published = []
    sess = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0], map_sink=lambda sc, mp: published.append(sc),
                       device="cpu")
    sess.run(scan_stream(seq, 8))
    assert len(published) >= 2 and len(published) == sess._keyframe_count
    published2 = []
    sess2 = LiveSession(cfg=dataclasses.replace(cfg, map_publishment_meters=2), initial_pose=seq.gt_poses[0],
                        map_sink=lambda sc, mp: published2.append(sc), device="cpu")
    sess2.run(scan_stream(seq, 8))
    assert 0 < len(published2) <= (len(published) + 1) // 2


def test_live_gt_map_bootstrap(tmp_path, seq):
    """The map from a PCD (InitWithGTPointCloud) with keyframes off: pure
    localization."""
    from locus_tpu_torch.io import pcd, synthetic

    world = synthetic.BoxWorld()
    world.add_shell([-2.0, -2.0, -1.0], [30.0, 2.0, 2.0])
    pts = []
    for i in range(12):
        w = seq.gt_poses[min(i, len(seq.gt_poses) - 1)]
        p, v = synthetic.simulate_scan(world, w, azimuth_steps=512, noise=0.0, seed=9 + i)
        pts.append((p[v] @ w[:3, :3].T) + w[:3, 3])
    path = str(tmp_path / "gt_map.pcd")
    pcd.write_pcd(path, np.concatenate(pts).astype(np.float32))
    cfg = _tcfg().replace(b_run_with_gt_point_cloud=True, gt_point_cloud_filename=path, b_add_keyframes_enabled=False)
    sess = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0], device="cpu")
    assert int(sess.state.map.cloud.count()) > 1000
    poses = sess.run(scan_stream(seq, 6))
    assert np.linalg.norm(poses[-1][:3, 3] - seq.gt_poses[5][:3, 3]) < 0.25
    assert sess._keyframe_count == 0


def _closure_cfg():
    from locus_tpu.config import FilterConfig, FusionConfig, LocusConfig, MapperConfig

    return LocusConfig(
        scan_capacity=256, raw_scan_capacity=1024, points_to_process_in_callback=200,
        filtering=FilterConfig(normals_k=8),
        mapper=MapperConfig(map_capacity=4096, keyframe_capacity=256, map_voxel_leaf=0.1),
        fusion=FusionConfig(data_integration_mode=0), b_enable_computation_time_profiling=False,
    )


def test_apply_loop_closure_matches_jax():
    """apply_loop_closure (tests/test_live.py:264's unsharded half): the
    corrected pose installed, the map moved by keyframe provenance, the
    keyframe anchor moved; as JAX's session does it."""
    jcfg = _closure_cfg()
    seq = make_tunnel_sequence(num_scans=3, azimuth_steps=64, seed=17)
    corr = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    corr[:, 0, 3] = 0.25
    corrected = seq.gt_poses[2].astype(np.float32).copy()
    corrected[0, 3] += 0.25
    j = JLive(cfg=jcfg, initial_pose=seq.gt_poses[0])
    t = LiveSession(cfg=_tcfg(jcfg), initial_pose=seq.gt_poses[0], device="cpu")
    for s in (j, t):
        for i in range(3):
            s.process_scan(float(seq.stamps[i]), seq.scans[i], seq.scan_valid[i])
    before = t.state.map
    j.apply_loop_closure(corrected, corr)
    t.apply_loop_closure(corrected, corr)
    np.testing.assert_array_equal(t.state.loc.integrated.numpy(), corrected)
    np.testing.assert_array_equal(t.state.last_keyframe_pose.numpy(), corrected)
    np.testing.assert_array_equal(np.asarray(j.state.loc.integrated), corrected)
    m = before.cloud.mask.numpy()
    moved = t.state.map.cloud.xyz.numpy()[m] - before.cloud.xyz.numpy()[m]
    np.testing.assert_allclose(moved, np.tile([0.25, 0, 0], (m.sum(), 1)), atol=1e-5)
    jm = np.asarray(j.state.map.cloud.mask)
    assert int(m.sum()) == int(jm.sum())
    np.testing.assert_allclose(np.sort(t.state.map.cloud.xyz.numpy()[m], axis=0),
                               np.sort(np.asarray(j.state.map.cloud.xyz)[jm], axis=0), atol=POSE_TOL_M)


def test_prewarm_loop_closure_is_a_noop(seq):
    """After the prewarm, closures at growing keyframe counts use the
    same padded table and build or allocate nothing."""
    sess = LiveSession(cfg=_tcfg(), initial_pose=seq.gt_poses[0], device="cpu")
    sess.run(scan_stream(seq, 3))
    pose, kf_pose = sess.state.loc.integrated.clone(), sess.state.last_keyframe_pose.clone()
    xyz = sess.state.map.cloud.xyz.clone()
    sess.prewarm_loop_closure()
    torch.testing.assert_close(sess.state.loc.integrated, pose, rtol=0, atol=0)
    torch.testing.assert_close(sess.state.last_keyframe_pose, kf_pose, rtol=0, atol=0)
    torch.testing.assert_close(sess.state.map.cloud.xyz, xyz, rtol=0, atol=0)
    counts = (build.builds, len(build._libs), tnn.buffer_allocations)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.01
    for K in (3, 70):
        sess.apply_loop_closure(sess.state.loc.integrated.numpy(), np.tile(T, (K, 1, 1)))
    assert (build.builds, len(build._libs), tnn.buffer_allocations) == counts


def test_live_step_equals_replay_step(seq):
    """One upload and one fetch compute what the replay step computes, bit
    for bit; the scan counter rides the aux vector bitwise, past 2^24."""
    cfg = _tcfg()
    tseq = TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})
    rstep, aux_len = runner.make_live_step(cfg, 16, 4)
    assert aux_len == 2 + 16 * 5 + 4 * 17
    init = pipeline.init_state(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device="cpu")
    a = b = init
    counter = (1 << 24) + 1
    for i in range(3):
        args = runner.scan_inputs(tseq, i, cfg, "cpu")
        xyz, mask, stamp, imu_s, imu_q, odom_s, odom_p, _ = args
        aux = torch.cat([stamp.reshape(1), torch.tensor([counter + i], dtype=torch.int32).view(torch.float32),
                         imu_s, imu_q.reshape(-1), odom_s, odom_p.reshape(-1)])
        a, packed = rstep(a, torch.cat([xyz, mask[:, None].float()], dim=1), aux)
        b, out = runner.replay_step(b, *args[:-1], torch.tensor(counter + i, dtype=torch.int32), cfg=cfg)
        unpacked = runner.unpack_live_output(packed.numpy())
        np.testing.assert_array_equal(unpacked.pose, out.pose.numpy())
        np.testing.assert_array_equal(unpacked.covariance, out.covariance.numpy())
        assert unpacked.keyframe_inserted == bool(out.keyframe_inserted)
        assert unpacked.num_points == int(out.num_points) and unpacked.map_size == int(out.map_size)
        assert unpacked.prior_source == int(out.prior_source)
        assert int(a.stats.last_seq) == counter + i
    for x, y in zip(a.map.cloud, b.map.cloud):
        assert torch.equal(x, y)


def test_unported_options_raise():
    """`mesh=` of the session and the live step takes a parallel.mesh.Mesh
    (TypeError otherwise) over whose map columns the map splits into whole
    B2 chunks (ValueError otherwise); NCCL refuses more ranks than visible
    devices."""
    from locus_tpu_torch.parallel import mesh as tmesh

    with pytest.raises(TypeError, match="Mesh"):
        LiveSession(cfg=_tcfg(), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        runner.make_live_step(_tcfg(), 16, 4, mesh=object())
    odd = tmesh.Mesh(1, 3, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="multiple of"):
        runner.make_live_step(_tcfg(), 16, 4, mesh=odd)
    with pytest.raises(ValueError, match="NCCL"):
        tmesh.make_mesh(4, map_parallel=2, device_type="cuda", backend="nccl")


def test_live_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveSession(cfg=_tcfg())


def test_live_serving_endurance_scaled(tmp_path):
    """chip_smoke.py's live phase at CI shapes (tools/live_endurance.py
    --ci: 1024-point scans, 360 azimuth steps, an 8192-slot map) on the
    CPU around a 2-lap, 60-scan circuit: loop closures pushed back,
    nothing built or allocated after the prewarm, the resumed session bit
    for bit, a bounded trajectory."""
    cfg = tconfig.LocusConfig(
        scan_capacity=1024, raw_scan_capacity=8192, points_to_process_in_callback=800,
        filtering=tconfig.FilterConfig(normals_k=12),
        mapper=tconfig.MapperConfig(map_capacity=1 << 13, keyframe_capacity=1024, map_voxel_leaf=0.15),
    )
    circuit = chip_smoke.circuit_sequence(60, 360, workers=2)
    rec, poses = chip_smoke.serve_live(torch, np, chip_smoke.serving_config(cfg), circuit, torch.device("cpu"),
                                       Path(tmp_path), resume_at=20)
    assert np.isfinite(poses).all()
    assert rec["closures_pushed_back"] >= 1 and rec["keyframes"] >= 15
    assert rec["resume_bit_equal"] and not rec["push_back_inside_resume_window"]
    assert rec["kernel_builds_after_prewarm"] == rec["buffer_allocations_after_prewarm"] == 0
    assert rec["ab_max_translation_m"] == 0.0     # one path on the CPU
    assert rec["ate_m"] < 0.1 and rec["final_error_m"] < 0.1, rec
