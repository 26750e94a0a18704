"""The port's scan-to-scan odometry (`locus_tpu_torch/odometry.py`)
against the JAX package's: the cases of tests/test_odometry.py (the
reference's hollow-cube shift recovery, gating, the prior warm start and
flat ground), each run through both packages on the same numpy clouds.
Every integrated pose agrees within 1e-4 m and 1e-4 rad (the GICP
tolerance of tests/test_torch_gicp.py), the performed and accepted flags
exactly; the JAX test's own assertions then hold on the port's poses."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from locus_tpu import odometry as jodo
from locus_tpu.config import RegistrationConfig
from locus_tpu.core.cloud import PointCloud as JCloud
from locus_tpu.io import synthetic
from locus_tpu_torch import config as tconfig
from locus_tpu_torch import odometry as todo
from locus_tpu_torch.core.cloud import PointCloud as TCloud
from tests.torch_helpers import np_, pose_diff

TOL_M, TOL_RAD = 1e-4, 1e-4


def _clouds(shift=(0.0, 0.0, 0.0)):
    xyz, nrm = synthetic.hollow_cube(step=0.1)
    xyz = (xyz + np.asarray(shift, np.float32)).astype(np.float32)
    return (JCloud.from_points(xyz, capacity=1024, normals=nrm),
            TCloud.from_points(xyz, capacity=1024, normals=nrm, device="cpu"))


def _run(shifts, cfg=RegistrationConfig(), priors=None, flat_ground=False):
    """Feed the cube at each shift through both packages; returns the
    port's updates after checking every one against JAX's."""
    tcfg = tconfig.RegistrationConfig(**dataclasses.asdict(cfg))
    jst, tst = jodo.init_state(1024), todo.init_state(1024, device="cpu")
    priors = priors or [None] * len(shifts)
    out = []
    for shift, prior in zip(shifts, priors):
        jc, tc = _clouds(shift)
        jp = None if prior is None else jnp.asarray(prior)
        tp = None if prior is None else torch.as_tensor(prior)
        ju = jodo.update(jst, jc, prior=jp, cfg=cfg, flat_ground=flat_ground)
        tu = todo.update(tst, tc, prior=tp, cfg=tcfg, flat_ground=flat_ground)
        dt, dr = pose_diff(np_(tu.state.integrated), np_(ju.state.integrated))
        assert dt < TOL_M and dr < TOL_RAD, (shift, dt, dr)
        assert bool(tu.performed) == bool(ju.performed) and bool(tu.accepted) == bool(ju.accepted)
        jst, tst = ju.state, tu.state
        out.append(tu)
    return out


def test_first_scan_no_motion():
    (upd,) = _run([(0, 0, 0)])
    assert not bool(upd.performed)
    np.testing.assert_allclose(np_(upd.state.integrated), np.eye(4), atol=1e-6)
    assert bool(upd.state.initialized)


def test_update_estimate_update_icp():
    """Scan content shifted by +0.05 means the sensor moved by -0.05
    (reference UpdateEstimateUpdateICP, tolerance 1e-2)."""
    _, upd = _run([(0, 0, 0), (0.05, 0, 0)])
    assert bool(upd.performed) and bool(upd.accepted)
    np.testing.assert_allclose(np_(upd.state.integrated)[:3, 3], [-0.05, 0, 0], atol=1e-2)
    np.testing.assert_allclose(np.linalg.inv(np_(upd.icp.transform))[:3, 3], [0.05, 0, 0], atol=1e-2)


def test_integration_over_scans():
    *_, upd = _run([(0, 0, 0), (0.05, 0, 0), (0.10, 0, 0)])
    np.testing.assert_allclose(np_(upd.state.integrated)[:3, 3], [-0.10, 0, 0], atol=2e-2)


def test_gating_rejects_large_jump():
    _, upd = _run([(0, 0, 0), (0.08, 0, 0)], cfg=RegistrationConfig(max_translation=0.02, corr_dist=1.0))
    assert not bool(upd.accepted)
    np.testing.assert_allclose(np_(upd.state.integrated)[:3, 3], [0, 0, 0], atol=1e-6)


def test_prior_warm_start():
    prior = np.eye(4, dtype=np.float32)
    prior[0, 3] = -0.28
    _, upd = _run([(0, 0, 0), (0.3, 0, 0)], priors=[None, prior])
    np.testing.assert_allclose(np_(upd.state.integrated)[:3, 3], [-0.3, 0, 0], atol=2e-2)


def test_flat_ground():
    _, upd = _run([(0, 0, 0), (0.05, 0, 0.04)], flat_ground=True)
    t = np_(upd.state.integrated)[:3, 3]
    assert abs(t[2]) < 1e-6
    np.testing.assert_allclose(t[0], -0.05, atol=1e-2)
