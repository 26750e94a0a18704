"""The port's batched step (ROADMAP A15b) against each robot's single
replay, bit for bit, and against JAX's make_batched_replay within 1e-2 m
/ 1e-2 rad (the cases and their tolerances: tests/torch_batched_cases.py):
NDT (irls, and newton with Moré–Thuente), the LOAM features, the
voxel-hash map, and MultiRobotSession on NDT. The other configurations:
test_torch_batched_configs2.py.
"""
import numpy as np
import pytest

from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu.live import MultiRobotSession as JMulti
from locus_tpu_torch.live import MultiRobotSession
from tests.torch_batched_cases import (
    JAX_TOL_M, JAX_TOL_RAD, NO_JAX, port_cfg, check_matches_jax, check_matches_single, config,
    write_gt_pcd,
)
from tests.torch_helpers import pose_diff

CONFIGS = ["ndt", "ndt_newton", "features", "voxel_hash"]


@pytest.fixture(scope="module")
def gt_pcd(tmp_path_factory):
    return write_gt_pcd(tmp_path_factory)


@pytest.mark.parametrize("name", CONFIGS)
def test_batched_config_matches_single(name, gt_pcd):
    check_matches_single(name, gt_pcd)


@pytest.mark.parametrize("name", [c for c in CONFIGS if c not in NO_JAX])
def test_batched_config_matches_jax(name, gt_pcd):
    check_matches_jax(name, gt_pcd)


def test_multi_robot_session_ndt_matches_jax():
    """Both packages' MultiRobotSession on NDT, two robots on their own
    tunnels, IMU and wheel odometry fed to robot 0 (the sizes of
    test_torch_batched_replay.py's session case)."""
    seq_a = make_tunnel_sequence(num_scans=6, azimuth_steps=256, step=0.3, seed=2)
    seq_b = make_tunnel_sequence(num_scans=6, azimuth_steps=256, step=0.4, seed=9)
    jcfg = config("ndt")
    init = np.stack([seq_a.gt_poses[0], seq_b.gt_poses[0]])
    jm = JMulti(cfg=jcfg, num_robots=2, initial_poses=init)
    tm = MultiRobotSession(cfg=port_cfg(jcfg), num_robots=2, initial_poses=init, device="cpu")
    for i in range(6):
        for m in (jm, tm):
            m.feed_imu(0, seq_a.stamps[i] - 0.01, [1.0, 0.0, 0.0, 0.0])
            m.feed_odom(0, seq_a.stamps[i] - 0.01, seq_a.gt_poses[i])
        args = ([seq_a.stamps[i], seq_b.stamps[i]], [seq_a.scans[i], seq_b.scans[i]],
                [seq_a.scan_valid[i], seq_b.scan_valid[i]])
        jp = jm.process_scans(*args)[0]
        tp, outs = tm.process_scans(*args)
        assert outs.loc_iterations.shape == (2,)
        for b in range(2):
            dt, dr = pose_diff(tp[b], jp[b])
            assert dt < JAX_TOL_M and dr < JAX_TOL_RAD, (i, b, dt, dr)
