"""GICP of the port against the JAX package and the float64 oracle, on the
fixtures of tests/test_gicp.py and tests/test_oracle.py.

The JAX side runs both its paths: the XLA path (dense 1-NN) and the
Pallas path in interpret mode (the visit-list 1-NN the port mirrors).
Tolerances: transform within 1e-4 m / 1e-4 rad of JAX with equal
iteration counts; within 1e-3 m / 1e-3 rad of the float64 oracle, the
gate tests/test_oracle.py holds the JAX package to (the oracle solves
in float64 with a KD-tree, so f32 rounding of either side shows at
~1e-4)."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest

from locus_tpu.config import RegistrationConfig as JRC
from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.geometry import se3 as jse3
from locus_tpu.io import synthetic
from locus_tpu.ops.dispatch import force_pallas
from locus_tpu.registration.gicp import gicp_register as jgicp
from locus_tpu_torch.config import RegistrationConfig as TRC
from locus_tpu_torch.registration.gicp import gicp_register as tgicp
from locus_tpu_torch.registration.registry import make_registrar
from tests.oracle_gicp import oracle_gicp
from tests.torch_helpers import np_, pose_diff, to_torch, torch_cloud

TOL = 1e-4
ORACLE_TOL = 1e-3


def _cube(capacity=1024, step=0.1, **kw):
    xyz, nrm = synthetic.hollow_cube(step=step, **kw)
    return JPC.from_points(jnp.asarray(xyz), capacity=capacity, normals=jnp.asarray(nrm))


def _T(w, t):
    return np_(jse3.make_transform(jse3.so3_exp(jnp.asarray(w, jnp.float32)), jnp.asarray(t, jnp.float32)))


CASES = {
    # test_gicp.py fixtures
    "translation": dict(src=lambda: _cube(), T=_T([0, 0, 0], [0.05, 0.0, 0.0]), cfg=dict(corr_dist=1.0)),
    "rigid": dict(src=lambda: _cube(), T=_T([0.02, -0.03, 0.05], [0.04, -0.03, 0.02]), cfg={}),
    "warm_start": dict(src=lambda: _cube(), T=_T([0, 0, 0.3], [0.4, 0.1, 0.0]), cfg={},
                       guess=_T([0.02, 0.02, 0.32], [0.37, 0.07, -0.03])),
    "identity_gated": dict(src=lambda: _cube(), T=np.eye(4, dtype=np.float32), cfg=dict(corr_dist=0.5)),
    "iteration_cap": dict(src=lambda: _cube(), T=_T([0.0, 0.0, 0.04], [0.08, -0.05, 0.03]),
                          cfg=dict(iterations=2, final_correspondence_relookup=True)),
    # test_oracle.py rotation fixture
    "oracle_rotation": dict(src=lambda: _cube(capacity=2048, step=0.15, side=4.0, jitter=0.01, seed=7),
                            T=_T([0.01, -0.02, 0.04], [0.04, 0.02, -0.03]), cfg={}),
}


@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gicp_matches_jax(case, path):
    c = CASES[case]
    src = c["src"]()
    tgt = src.transform(jnp.asarray(c["T"]))
    guess = c.get("guess")
    ctx = force_pallas() if path == "pallas" else contextlib.nullcontext()
    with ctx:
        j = jgicp(src, tgt, None if guess is None else jnp.asarray(guess), JRC(**c["cfg"]))
    t = tgicp(torch_cloud(src), torch_cloud(tgt), None if guess is None else to_torch(guess), TRC(**c["cfg"]))
    dt, dr = pose_diff(np_(t.transform), np_(j.transform))
    assert dt < TOL and dr < TOL, (dt, dr)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_correspondences) == int(j.num_correspondences)
    np.testing.assert_array_equal(np_(t.corr_mask), np_(j.corr_mask))
    # correspondences: equal, or the two targets tie in distance (the cube
    # repeats its edge points) within 1e-5 m^2
    m = np_(t.corr_mask)
    T = np_(t.transform).astype(np.float64)
    p = np_(src.xyz)[m].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    tx = np_(tgt.xyz).astype(np.float64)
    d_t = ((p - tx[np_(t.correspondences)[m]]) ** 2).sum(1)
    d_j = ((p - tx[np_(j.correspondences)[m]]) ** 2).sum(1)
    np.testing.assert_allclose(d_t, d_j, atol=1e-5, rtol=0)
    # mean squared pair distance: the d2 tolerance above
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["translation", "rigid", "oracle_rotation"])
def test_gicp_matches_oracle(case):
    c = CASES[case]
    src = c["src"]()
    tgt = src.transform(jnp.asarray(c["T"]))
    cfg = TRC(**c["cfg"])
    t = tgicp(torch_cloud(src), torch_cloud(tgt), None, cfg)
    m = np_(src.mask)
    T_oracle, _, conv = oracle_gicp(
        np_(src.xyz)[m].astype(np.float64), np_(src.normals)[m].astype(np.float64),
        np_(tgt.xyz)[m].astype(np.float64), np_(tgt.normals)[m].astype(np.float64),
        corr_dist=cfg.corr_dist, epsilon=cfg.gicp_epsilon, max_iterations=cfg.iterations,
        tf_epsilon=cfg.tf_epsilon, rotation_epsilon=cfg.rotation_epsilon,
    )
    assert conv
    dt, dr = pose_diff(np_(t.transform), T_oracle)
    assert dt < ORACLE_TOL and dr < ORACLE_TOL, (dt, dr)
    np.testing.assert_allclose(np_(t.transform)[:3, 3], c["T"][:3, 3], atol=1e-2)


def test_padding_invariance():
    """Extra padding lanes must not change the solution."""
    xyz, nrm = synthetic.hollow_cube(step=0.1)
    from locus_tpu_torch.core.cloud import PointCloud

    T = to_torch(_T([0, 0, 0], [0.05, 0.0, 0.0]))
    small = PointCloud.from_points(xyz, capacity=800, normals=nrm)
    big = PointCloud.from_points(xyz, capacity=1600, normals=nrm)
    r1 = tgicp(small, small.transform(T), cfg=TRC())
    r2 = tgicp(big, big.transform(T), cfg=TRC())
    np.testing.assert_allclose(np_(r1.transform), np_(r2.transform), atol=1e-5)


def test_registry_and_unported_modes():
    """Both registration methods resolve; the covariance modes other than
    the disk path run single only (the batched step is ROADMAP A15b)."""
    import torch

    from locus_tpu_torch.registration.ndt import ndt_register

    src = torch_cloud(_cube(capacity=256, step=0.25))
    res = make_registrar(TRC())(src, src)
    np.testing.assert_allclose(np_(res.transform), np.eye(4), atol=1e-5)
    res = make_registrar(TRC(registration_method="ndt", ndt_resolution=0.5))(src, src)
    assert np.isfinite(np_(res.transform)).all()
    res = tgicp(src, src, cfg=TRC(covariance_mode="adaptive"))
    np.testing.assert_allclose(np_(res.transform), np.eye(4), atol=1e-5)
    batched = type(src)(*(torch.stack([a, a]) for a in src))
    with pytest.raises(NotImplementedError, match="A15b"):
        tgicp(batched, batched, cfg=TRC(covariance_mode="adaptive"))
    with pytest.raises(NotImplementedError, match="A15b"):
        ndt_register(batched, batched, cfg=TRC(registration_method="ndt"))
    with pytest.raises(ValueError):
        make_registrar(TRC(registration_method="icp"))
