"""The port's scan-to-submap localization
(`locus_tpu_torch/localization.py`) against the JAX package's: the cases
of tests/test_localization.py on the same numpy inputs. Transforms agree
within 1e-5, Ap within 1e-5 relative, covariances and condition numbers
within 1e-5 relative (one f32 Jacobi eigendecomposition each), the
measurement update within 1e-4 m (GICP); the JAX test's assertions then
hold on the port's values."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from locus_tpu import localization as jloc
from locus_tpu.config import LocalizationConfig
from locus_tpu.core.cloud import PointCloud as JCloud
from locus_tpu.geometry import se3 as jse3
from locus_tpu.io import synthetic
from locus_tpu_torch import config as tconfig
from locus_tpu_torch import localization as tloc
from locus_tpu_torch.core.cloud import PointCloud as TCloud
from locus_tpu_torch.utils.linalg import jacobi_eigh
from tests.torch_helpers import np_, pose_diff, to_torch


def _plane():
    xyz, nrm = synthetic.plane(nx=20, ny=20, step=0.1, z=0.0)
    return JCloud.from_points(xyz, capacity=512, normals=nrm), TCloud.from_points(xyz, capacity=512, normals=nrm, device="cpu")


def _T(rotvec, t):
    return np.array(jse3.make_transform(jse3.so3_exp(jnp.asarray(rotvec, jnp.float32)), jnp.asarray(t, jnp.float32)))


def _states():
    return jloc.init_state(), tloc.init_state(device="cpu")


def test_motion_update():
    T = _T([0, 0, 0], [1.0, 2.0, 3.0])
    js, ts = _states()
    js, ts = jloc.motion_update(js, jnp.asarray(T)), tloc.motion_update(ts, torch.as_tensor(T))
    np.testing.assert_array_equal(np_(ts.incremental), np_(js.incremental))
    np.testing.assert_array_equal(np_(ts.incremental), T)


def test_transform_roundtrip():
    T = _T([0.1, 0.2, 0.3], [1.0, -2.0, 0.5])
    js, ts = _states()
    js, ts = jloc.motion_update(js, jnp.asarray(T)), tloc.motion_update(ts, torch.as_tensor(T))
    jpc, tpc = _plane()
    jfixed, tfixed = jloc.transform_points_to_fixed_frame(js, jpc), tloc.transform_points_to_fixed_frame(ts, tpc)
    m = np_(tpc.mask)
    np.testing.assert_allclose(np_(tfixed.xyz)[m], np_(jfixed.xyz)[m], atol=1e-5)
    back = tloc.transform_points_to_sensor_frame(ts, tfixed)
    np.testing.assert_allclose(np_(back.xyz)[m], np_(tpc.xyz)[m], atol=1e-4)


def test_set_integrated_estimate():
    T = _T([0, 0, 0.4], [5.0, 0.0, 0.0])
    js, ts = _states()
    js = jloc.set_integrated_estimate(js, jnp.asarray(T))
    ts = tloc.set_integrated_estimate(ts, T)
    np.testing.assert_array_equal(np_(ts.integrated), np_(js.integrated))
    assert ts.integrated.dtype == torch.float32


def test_normalize_cloud():
    """normalizePCloud (utils.cc): centroid 0, mean radius 1."""
    xyz = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32) * 3 + 5
    j = np_(jloc.normalize_cloud_points(jnp.asarray(xyz), jnp.ones(100, dtype=bool)))
    t = np_(tloc.normalize_cloud_points(torch.as_tensor(xyz), torch.ones(100, dtype=torch.bool)))
    np.testing.assert_allclose(t, j, atol=1e-5)
    np.testing.assert_allclose(t.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1).mean(), 1.0, atol=1e-4)


def test_compute_ap_hand_value():
    q = np.asarray([[1.0, 0, 0], [-1.0, 0, 0]], np.float32)
    nrm = np.asarray([[0.0, 0, 1.0], [0.0, 0, 1.0]], np.float32)
    corr = np.asarray([0, 1], np.int32)
    mask = np.ones(2, bool)
    j = np_(jloc.compute_ap_point2plane(*(jnp.asarray(a) for a in (q, mask, nrm, corr, mask))))
    t = np_(tloc.compute_ap_point2plane(*(torch.as_tensor(a) for a in (q, mask, nrm, corr.astype(np.int64), mask))))
    H1, H2 = np.array([0, -1, 0, 0, 0, 1.0]), np.array([0, 1, 0, 0, 0, 1.0])
    np.testing.assert_allclose(t, j, atol=1e-6)
    np.testing.assert_allclose(t, np.outer(H1, H1) + np.outer(H2, H2), atol=1e-5)


def _covariances(Ap, icp_max_covariance=0.01):
    jc, jk = jloc.point2plane_covariance(jnp.asarray(Ap), icp_max_covariance=icp_max_covariance)
    tc, tk = tloc.point2plane_covariance(torch.as_tensor(Ap), icp_max_covariance=icp_max_covariance)
    np.testing.assert_allclose(np_(tc), np_(jc), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(float(tk), float(jk), rtol=1e-5)
    return np_(tc), float(tk)


def test_covariance_clamping():
    cov, _ = _covariances(np.eye(6, dtype=np.float32) * 1e-20)
    assert np.linalg.eigvalsh(cov).max() <= 0.01 + 1e-6
    cov2, _ = _covariances(np.eye(6, dtype=np.float32) * 1e6)
    assert np.linalg.eigvalsh(cov2).max() < 1e-3


def test_observability_plane():
    """A plane constrains z, roll and pitch: three near-zero eigenvalues
    of Ap (x, y, yaw unobservable)."""
    jpc, tpc = _plane()
    jAp = jloc.compute_ap_point2plane(jpc.xyz, jpc.mask, jpc.normals, jnp.arange(512, dtype=jnp.int32), jpc.mask)
    tAp = tloc.compute_ap_point2plane(tpc.xyz, tpc.mask, tpc.normals, torch.arange(512), tpc.mask)
    np.testing.assert_allclose(np_(tAp), np_(jAp), rtol=1e-5, atol=1e-3)
    ev = np_(tloc.compute_observability(tAp)[0])
    np.testing.assert_allclose(ev, np_(jloc.compute_observability(jAp)[0]), atol=1e-3)
    assert np.sum(ev < 1e-4) == 3


def test_measurement_update_recovers_offset():
    jpc, tpc = _plane()
    T = _T([0, 0, 0], [0.0, 0.0, 0.03])
    jref, tref = jpc.transform(jnp.asarray(T)), tpc.transform(torch.as_tensor(T))
    cfg = LocalizationConfig()
    tcfg = tconfig.LocalizationConfig(
        **{**dataclasses.asdict(cfg), "registration": tconfig.RegistrationConfig(**dataclasses.asdict(cfg.registration))})
    jres = jloc.measurement_update(jloc.init_state(), jpc, jref, cfg=cfg)
    tres = tloc.measurement_update(tloc.init_state(device="cpu"), tpc, tref, cfg=tcfg)
    dt, dr = pose_diff(np_(tres.state.integrated), np_(jres.state.integrated))
    assert dt < 1e-4 and dr < 1e-4, (dt, dr)
    assert bool(tres.accepted) == bool(jres.accepted) is True
    np.testing.assert_allclose(np_(tres.state.integrated)[2, 3], 0.03, atol=5e-3)
    assert np.all(np.isfinite(np_(tres.state.covariance)))
    assert float(tres.state.condition_number) >= 1.0


def test_jacobi_eigh_matches_numpy():
    """The port's Jacobi reaches f32 accuracy on ill-conditioned 6x6
    inputs (spectra 1e-8..1e2), as the JAX test asks of JAX's."""
    rng = np.random.default_rng(7)
    for _ in range(25):
        Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        lam = 10.0 ** rng.uniform(-8, 2, 6)
        A = ((Q * lam) @ Q.T).astype(np.float32)
        A = 0.5 * (A + A.T)
        ev, V = (np_(x) for x in jacobi_eigh(to_torch(A)))
        np.testing.assert_allclose(ev, np.sort(lam), rtol=3e-5, atol=1e-6 * lam.max())
        np.testing.assert_allclose((V * ev) @ V.T, A, atol=3e-5 * max(1.0, lam.max()))


def test_covariance_from_ap_eig_matches_inverse():
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    Ap = ((Q * np.array([2e3, 1e3, 5e2, 1e2, 5e1, 1e1])) @ Q.T).astype(np.float32)
    Ap = 0.5 * (Ap + Ap.T)
    cov, cond = _covariances(Ap)
    ref = 0.05 * 0.05 * np.linalg.inv(Ap + 1e-9 * np.eye(6))
    np.testing.assert_allclose(cov, ref, rtol=5e-4, atol=1e-9)
    w = np.linalg.eigvalsh(ref)
    np.testing.assert_allclose(cond, w.max() / w.min(), rtol=1e-3)
