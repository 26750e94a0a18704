"""The port's whole per-scan pipeline against the JAX package.

(a) The golden replay: tests/data/golden_seq.npz under
    small_cfg(fusion=FusionConfig(data_integration_mode=3)) within 2 cm of
    tests/data/golden_poses.npy, the gate test_golden.py sets for JAX.
(b) Scan by scan against locus_tpu.runner.run_sequence on a 12-scan
    synthetic tunnel.
(c) JAX runs 4 scans; its state goes through convert.state_from_numpy;
    the port runs 4 more and is held against JAX's scans 5 to 8.
(d) The other single-card configurations on (b)'s tunnel: NDT in both
    stages, the LOAM features with adaptive covariances in both stages,
    the voxel-hash map, keyframes at map resolution, and the grid,
    outlier and radius filters; the in-graph space monitor scan by scan;
    and the ground-truth-map bootstrap from a PCD.
(e) The other sensor-fusion modes on (b)'s tunnel (`_mode_case`): pure
    lidar odometry with the flat-ground projection (mode 0); the IMU
    prior from an IMU mounted at 90 degrees of roll, converted to the base
    frame (mode 1, b_convert_imu_to_base_link_frame); the yaw-only IMU
    prior with the IMU silent for 0.5 s, longer than the health timeout,
    so that the cascade fails over to lidar odometry and back (mode 2);
    and the spot profile (mode 1 with interpolated odometry and 25
    scan-to-submap iterations, LocusConfig.robot_profile("spot")). Prior
    sources must be equal scan by scan; every replay passes the
    transform-threshold gate.

Tolerances of (b) to (e): pose within 1e-2 m and 1e-2 rad per scan,
keyframe decisions equal, map size within 0.5 %. The pose tolerance is
what f32 allows on this sequence, not what the port would like: in
several scans the scan-to-submap GICP ends on its iteration cap without
converging, and where it ends then depends on rounding; thin
neighbourhoods give normals that f32 cannot resolve. The JAX package's
own two paths (XLA and Pallas, which differ only in such rounding)
disagree by 6.2e-3 m on (b)'s sequence. The random filter draws from
torch's generator, not the JAX PRNG, so (d) runs the grid, outlier and
radius filters without it (test_torch_filters.py holds it statistically).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import pipeline as jpl
from locus_tpu import runner as jrunner
from locus_tpu.config import FusionConfig, LocusConfig
from locus_tpu.io.dataset import Sequence, make_tunnel_sequence
from locus_tpu_torch import runner as trunner
from locus_tpu_torch.convert import config_from_dict, state_from_numpy
from locus_tpu_torch.io.dataset import Sequence as TSequence
from tests.test_pipeline import small_cfg
from tests.torch_helpers import pose_diff

DATA = os.path.join(os.path.dirname(__file__), "data")
POSE_TOL_M = 1e-2
POSE_TOL_RAD = 1e-2
MAP_SIZE_RTOL = 5e-3


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _port_seq(seq):
    return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})


@pytest.fixture(scope="module")
def tunnel():
    return make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3, seed=1)


R = dataclasses.replace


def _both_stages(cfg, **kw):
    return cfg.replace(odometry=R(cfg.odometry, **kw),
                       localization=R(cfg.localization, registration=R(cfg.localization.registration, **kw)))


def _config(name):
    base = small_cfg(fusion=FusionConfig(data_integration_mode=3))
    if name == "ndt":
        return _both_stages(base, registration_method="ndt")
    if name == "features":
        base = base.replace(filtering=R(base.filtering, extract_features=True, feature_width=256))
        return _both_stages(base, covariance_mode="adaptive")
    if name == "voxel_hash":
        return base.replace(mapper=R(base.mapper, structure="voxel_hash"))
    if name == "keyframe_at_map_resolution":
        return base.replace(mapper=R(base.mapper, keyframe_at_map_resolution=True))
    assert name == "filters"
    return base.replace(
        filtering=R(base.filtering, grid_filter=True, outlier_filter=True, radius_filter=True, radius=0.8, radius_knn=3)
    )


def _assert_poses_close(tp, jp):
    for i, (a, b) in enumerate(zip(tp, jp)):
        dt, dr = pose_diff(a, b)
        assert dt < POSE_TOL_M and dr < POSE_TOL_RAD, (i, dt, dr)


def test_golden_trajectory():
    seq = Sequence.load(os.path.join(DATA, "golden_seq.npz"))
    cfg = _port_cfg(small_cfg(fusion=FusionConfig(data_integration_mode=3)))
    poses, _, _ = trunner.run_sequence(_port_seq(seq), cfg, device="cpu")
    golden = np.load(os.path.join(DATA, "golden_poses.npy"))
    err = np.linalg.norm(poses[:, :3, 3] - golden[:, :3, 3], axis=1)
    assert err.max() < 0.02, err.max()


def test_scan_by_scan_matches_jax(tunnel):
    jcfg = small_cfg(fusion=FusionConfig(data_integration_mode=3))
    jp, jo, _ = jrunner.run_sequence(tunnel, jcfg)
    tp, to, _ = trunner.run_sequence(_port_seq(tunnel), _port_cfg(jcfg), device="cpu")
    _assert_poses_close(tp, jp)
    assert [o["keyframe_inserted"] for o in to] == [o["keyframe_inserted"] for o in jo]
    for a, b in zip(to, jo):
        assert abs(a["map_size"] - b["map_size"]) <= MAP_SIZE_RTOL * b["map_size"], (a, b)
        assert a["prior_source"] == b["prior_source"]
        assert a["num_points"] == b["num_points"]


def test_state_carried_over_from_jax(tunnel):
    """4 scans in JAX, the state converted, 4 more in the port."""
    jcfg = small_cfg(fusion=FusionConfig(data_integration_mode=3))
    tcfg = _port_cfg(jcfg)
    tseq = _port_seq(tunnel)
    rstep = jrunner.make_replay_step(jcfg)
    jst = jpl.init_state_from_config(jcfg, initial_pose=jnp.asarray(tunnel.gt_poses[0], jnp.float32))
    jst = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jst)
    tst = None
    jposes, tposes, jkf, tkf, jms, tms = [], [], [], [], [], []
    for i in range(8):
        args = trunner.scan_inputs(tseq, i, tcfg, "cpu")
        if i == 4:
            tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
        if tst is not None:
            tst, tout = trunner.replay_step(tst, *args, cfg=tcfg)
            tposes.append(tout.pose.numpy())
            tkf.append(bool(tout.keyframe_inserted))
            tms.append(int(tout.map_size))
        jst, jout = rstep(jst, *[jnp.asarray(a.numpy()) for a in args])
        if i >= 4:
            jposes.append(np.asarray(jout.pose))
            jkf.append(bool(jout.keyframe_inserted))
            jms.append(int(jout.map_size))
    _assert_poses_close(tposes, jposes)
    assert tkf == jkf
    for a, b in zip(tms, jms):
        assert abs(a - b) <= MAP_SIZE_RTOL * b


def test_state_conversion_is_exact():
    """state_from_numpy copies every leaf; the map operand changes layout."""
    jcfg = small_cfg()
    jst = jpl.init_state(jcfg, initial_pose=jnp.eye(4))
    tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    assert tst.map.nn_aug.shape == (jst.map.nn_aug.shape[1], 4)
    np.testing.assert_array_equal(tst.map.nn_aug.numpy(), np.asarray(jst.map.nn_aug)[:4].T)
    np.testing.assert_array_equal(tst.odom.reference.xyz.numpy(), np.asarray(jst.odom.reference.xyz))
    np.testing.assert_array_equal(tst.fuse.odom.data.numpy(), np.asarray(jst.fuse.odom.data))
    assert tst.stats.last_seq.dtype == torch.int32 and int(tst.stats.last_seq) == -1


@pytest.mark.parametrize("name", ["ndt", "features", "voxel_hash", "keyframe_at_map_resolution", "filters"])
def test_configuration_matches_jax(tunnel, name):
    jcfg = _config(name)
    jp, jo, _ = jrunner.run_sequence(tunnel, jcfg)
    tp, to, _ = trunner.run_sequence(_port_seq(tunnel), _port_cfg(jcfg), device="cpu")
    _assert_poses_close(tp, jp)
    assert [o["keyframe_inserted"] for o in to] == [o["keyframe_inserted"] for o in jo]
    for a, b in zip(to, jo):
        assert abs(a["map_size"] - b["map_size"]) <= MAP_SIZE_RTOL * b["map_size"], (a, b)
        assert a["num_points"] == b["num_points"]
        assert a["voxel_leaf"] == pytest.approx(b["voxel_leaf"], rel=1e-6)


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _mode_case(name, tunnel):
    """(JAX config, sequence) of a fusion-mode replay of (e)."""
    base = small_cfg()
    fusion = base.fusion
    if name == "mode0_flat_ground":
        return base.replace(fusion=R(fusion, data_integration_mode=0), b_is_flat_ground_assumption=True), tunnel
    if name == "mode1_imu_mounted":
        q_bi = np.array([np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0])      # 90 degrees of roll
        quats = np.stack([_quat_mul(q, q_bi) for q in tunnel.imu_quats])       # the IMU's own orientation
        cfg = base.replace(fusion=R(fusion, data_integration_mode=1, b_convert_imu_to_base_link_frame=True,
                                    imu_to_base_quat=tuple(float(v) for v in q_bi)))
        return cfg, dataclasses.replace(tunnel, imu_quats=quats)
    if name == "mode2_imu_outage":
        keep = (tunnel.imu_stamps < 0.35) | (tunnel.imu_stamps > 0.85)
        seq = dataclasses.replace(tunnel, imu_stamps=tunnel.imu_stamps[keep], imu_quats=tunnel.imu_quats[keep])
        return base.replace(fusion=R(fusion, data_integration_mode=2)), seq
    assert name == "spot"
    spot = LocusConfig.robot_profile("spot")
    return base.replace(fusion=R(fusion, data_integration_mode=spot.fusion.data_integration_mode,
                                 b_integrate_interpolated_odom=spot.fusion.b_integrate_interpolated_odom),
                        localization=spot.localization), tunnel


@pytest.mark.parametrize("name", ["mode0_flat_ground", "mode1_imu_mounted", "mode2_imu_outage", "spot"])
def test_fusion_mode_matches_jax(tunnel, name):
    jcfg, seq = _mode_case(name, tunnel)
    jp, jo, _ = jrunner.run_sequence(seq, jcfg)
    tp, to, _ = trunner.run_sequence(_port_seq(seq), _port_cfg(jcfg), device="cpu")
    _assert_poses_close(tp, jp)
    assert [o["prior_source"] for o in to] == [o["prior_source"] for o in jo]
    assert [o["keyframe_inserted"] for o in to] == [o["keyframe_inserted"] for o in jo]
    assert all(o["scan_to_map_accepted"] for o in to[1:])
    for a, b in zip(to, jo):
        assert abs(a["map_size"] - b["map_size"]) <= MAP_SIZE_RTOL * b["map_size"], (a, b)
        assert a["num_points"] == b["num_points"]
    sources = {o["prior_source"] for o in to}
    expected = {"mode0_flat_ground": {0}, "mode1_imu_mounted": {0, 1}, "mode2_imu_outage": {0, 2},
                "spot": {0, 1}}[name]
    assert sources == expected, sources
    if name == "mode0_flat_ground":
        assert np.abs(tp[:, 2, 3] - tp[0, 2, 3]).max() < 1e-6     # no vertical motion
    if name == "mode2_imu_outage":
        lo = [i for i, o in enumerate(to) if o["prior_source"] == 0 and i > 1]
        assert lo and max(lo) < len(to) - 2, [o["prior_source"] for o in to]   # failed over, then back


def test_space_monitor_matches_jax(tunnel):
    """The in-graph space monitor: each scan's xy cross-section within
    1e-5 relative and the open-space flag equal; with a 100 m^2 threshold
    the tunnel reads as open space and the open-space keyframe thresholds
    apply."""
    base = small_cfg(fusion=FusionConfig(data_integration_mode=3))
    jcfg = base.replace(b_monitor_space=True, xy_cross_section_threshold=100.0)
    tcfg = _port_cfg(jcfg)
    tseq = _port_seq(tunnel)
    rstep = jrunner.make_replay_step(jcfg)
    jst = jpl.init_state_from_config(jcfg, initial_pose=jnp.asarray(tunnel.gt_poses[0], jnp.float32))
    jst = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jst)   # donated leaf by leaf
    tst = trunner.pipeline.init_state_from_config(tcfg, torch.as_tensor(tunnel.gt_poses[0], dtype=torch.float32), device="cpu")
    opened = []
    for i in range(4):
        args = trunner.scan_inputs(tseq, i, tcfg, "cpu")
        tst, tout = trunner.replay_step(tst, *args, cfg=tcfg)
        jst, jout = rstep(jst, *[jnp.asarray(a.numpy()) for a in args])
        assert float(tout.xy_cross_section) == pytest.approx(float(jout.xy_cross_section), rel=1e-5)
        assert bool(tst.open_space) == bool(jst.open_space)
        opened.append(bool(tst.open_space))
        _assert_poses_close([tout.pose.numpy()], [np.asarray(jout.pose)])
    assert all(opened)


@pytest.mark.parametrize("structure", ["ring", "voxel_hash"])
def test_gt_map_bootstrap_matches_jax(tunnel, tmp_path, structure):
    """The map from a PCD (no normals: kNN normals), keyframes off: pure
    localization against the prior map, as in the reference."""
    from locus_tpu.io.pcd import write_pcd

    world = np.concatenate([
        seq_xyz @ T[:3, :3].T + T[:3, 3]
        for seq_xyz, T in ((tunnel.scans[i][tunnel.scan_valid[i]][::3], tunnel.gt_poses[i]) for i in range(0, 12, 3))
    ]).astype(np.float32)
    path = tmp_path / "map.pcd"
    write_pcd(str(path), world)
    base = small_cfg(fusion=FusionConfig(data_integration_mode=3))
    jcfg = base.replace(
        b_run_with_gt_point_cloud=True, gt_point_cloud_filename=str(path), b_add_keyframes_enabled=False,
        mapper=R(base.mapper, structure=structure),
    )
    jp, jo, _ = jrunner.run_sequence(tunnel, jcfg, max_scans=6)
    tp, to, _ = trunner.run_sequence(_port_seq(tunnel), _port_cfg(jcfg), max_scans=6, device="cpu")
    _assert_poses_close(tp, jp)
    assert [o["map_size"] for o in to] == [o["map_size"] for o in jo]
    assert to[0]["map_size"] == min(world.shape[0], jcfg.mapper.map_capacity)


def test_unported_branches_raise():
    """The sharded map (A16), and the batched step outside the default
    configuration (A15b), raise."""
    from locus_tpu_torch import pipeline as tpl

    base = _port_cfg(small_cfg())
    with pytest.raises(NotImplementedError, match="A16"):
        tpl.init_state(base.replace(mapper=R(base.mapper, num_shards=2)), device="cpu")
    for cfg in (
        base.replace(filtering=R(base.filtering, extract_features=True)),
        base.replace(filtering=R(base.filtering, outlier_filter=True)),
        base.replace(filtering=R(base.filtering, normals_method="knn")),
        base.replace(mapper=R(base.mapper, structure="voxel_hash")),
        base.replace(odometry=R(base.odometry, registration_method="ndt")),
        base.replace(odometry=R(base.odometry, covariance_mode="adaptive")),
        base.replace(mapper=R(base.mapper, keyframe_at_map_resolution=True)),
        base.replace(b_monitor_space=True),
    ):
        with pytest.raises(NotImplementedError, match="A15b"):
            tpl.init_states(cfg, num_robots=2, device="cpu")
        state = tpl.stack_states([tpl.init_state(base, device="cpu")] * 2)
        seq = make_tunnel_sequence(num_scans=1, azimuth_steps=64, seed=0)
        args = [torch.stack([a, a]) for a in trunner.scan_inputs(_port_seq(seq), 0, cfg, "cpu")]
        with pytest.raises(NotImplementedError, match="A15b"):
            trunner.replay_step(state, *args, cfg=cfg)
