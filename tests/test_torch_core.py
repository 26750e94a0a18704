"""The port's skeleton and core against the JAX package: the config tree,
SE(3) utilities, small linear algebra and the point-cloud container.
Tolerance 1e-6 absolute for f32 geometry on unit-scale inputs (a few ulp
of the largest magnitude involved); configs must be equal."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import config as jcfg
from locus_tpu.core import cloud as jcloud
from locus_tpu.geometry import se3 as jse3
from locus_tpu.utils import linalg as jlinalg
from locus_tpu_torch import config as tcfg
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.core import cloud as tcloud
from locus_tpu_torch.geometry import se3 as tse3
from locus_tpu_torch.utils import linalg as tlinalg
from tests.torch_helpers import np_, to_torch

ATOL = 1e-6


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _field_tree(cls):
    out = {}
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        out[f.name] = _field_tree(type(default)) if dataclasses.is_dataclass(default) else (f.type, default)
    return out


def test_config_fields_and_defaults_match():
    assert _field_tree(tcfg.LocusConfig) == _field_tree(jcfg.LocusConfig)
    assert dataclasses.asdict(tcfg.LocusConfig()) == dataclasses.asdict(jcfg.LocusConfig())


@pytest.mark.parametrize("robot", ["husky", "spot", "other"])
def test_config_robot_profiles_match(robot):
    assert dataclasses.asdict(tcfg.LocusConfig.robot_profile(robot)) == dataclasses.asdict(
        jcfg.LocusConfig.robot_profile(robot)
    )


@pytest.mark.parametrize("name", ["husky.yaml", "spot.yaml"])
def test_config_load_yaml_matches(name):
    path = os.path.join(os.path.dirname(__file__), "..", "configs", name)
    assert dataclasses.asdict(tcfg.load_yaml(path)) == dataclasses.asdict(jcfg.load_yaml(path))


def test_config_from_dict_roundtrip():
    j = jcfg.LocusConfig(
        scan_capacity=1024,
        filtering=jcfg.FilterConfig(box_min=(-1.0, -1.0, -1.0), normals_k=12),
        mapper=jcfg.MapperConfig(map_capacity=8192),
        fusion=jcfg.FusionConfig(data_integration_mode=1),
    )
    t = config_from_dict(dataclasses.asdict(j))
    assert isinstance(t, tcfg.LocusConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

def _rand_pose(rng, n=None):
    shape = (n,) if n else ()
    w = rng.normal(size=shape + (3,)) * 0.8
    t = rng.normal(size=shape + (3,))
    R = np_(jse3.so3_exp(jnp.asarray(w, jnp.float32)))
    return np_(jse3.make_transform(jnp.asarray(R), jnp.asarray(t, jnp.float32)))


def _inputs(name, rng):
    """Arguments (numpy, f32) for the se3 function `name`."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    T, T2 = _rand_pose(rng, 5), _rand_pose(rng, 5)
    pts = f32(rng.normal(size=(5, 7, 3)) * 3)
    w = f32(rng.normal(size=(9, 3)) * 0.7)
    w[0] = 0.0
    w[1] = 1e-4
    q = f32(rng.normal(size=(6, 4)))
    R = np_(jse3.so3_exp(jnp.asarray(w)))
    table = {
        "make_transform": (R, f32(rng.normal(size=(9, 3)))),
        "inverse": (T,),
        "compose": (T, T2),
        "transform_points": (T, pts),
        "rotate_vectors": (T, pts),
        "skew": (w,),
        "so3_exp": (w,),
        "so3_log": (np.concatenate([R, np_(jse3.so3_exp(jnp.asarray(f32([[3.05, 0.1, 0.0]]))))]),),
        "se3_exp": (f32(np.concatenate([rng.normal(size=(9, 3)), w], 1)),),
        "se3_log": (T,),
        "quat_to_matrix": (q,),
        "matrix_to_quat": (R,),
        "quat_multiply": (q, q[::-1].copy()),
        "quat_conjugate": (q,),
        "quat_slerp": (q / np.linalg.norm(q, axis=1, keepdims=True), f32(rng.normal(size=(6, 4))) / 2, 0.3),
        "euler_zyx_to_matrix": tuple(f32(rng.normal(size=(4,))) for _ in range(3)),
        "matrix_to_euler_zyx": (R,),
        "yaw_only_matrix": (R,),
        "pose_delta": (T, T2),
        "rotation_angle": (R,),
        "translation_norm": (T,),
        "orthonormalize": (R + f32(rng.normal(size=R.shape) * 1e-3),),
    }
    return table[name]


SE3_FUNCS = [
    "make_transform", "inverse", "compose", "transform_points", "rotate_vectors",
    "skew", "so3_exp", "so3_log", "se3_exp", "se3_log", "quat_to_matrix",
    "matrix_to_quat", "quat_multiply", "quat_conjugate", "quat_slerp",
    "euler_zyx_to_matrix", "matrix_to_euler_zyx", "yaw_only_matrix",
    "pose_delta", "rotation_angle", "translation_norm", "orthonormalize",
]


@pytest.mark.parametrize("name", SE3_FUNCS)
def test_se3_matches_jax(name):
    rng = np.random.default_rng(SE3_FUNCS.index(name))
    args = _inputs(name, rng)
    j = getattr(jse3, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    t = getattr(tse3, name)(*(to_torch(a) if isinstance(a, np.ndarray) else a for a in args))
    js = j if isinstance(j, tuple) else (j,)
    ts = t if isinstance(t, tuple) else (t,)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(np_(b), np_(a), atol=ATOL, rtol=0)


def test_se3_identity():
    np.testing.assert_array_equal(np_(tse3.identity()), np_(jse3.identity()))


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

def test_chol_solve_matches_jax(rng):
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = A @ A.T + 0.5 * np.eye(6, dtype=np.float32)
    g = rng.normal(size=(6,)).astype(np.float32)
    j = np_(jlinalg.chol_solve(jnp.asarray(H), jnp.asarray(g)))
    t = np_(tlinalg.chol_solve(to_torch(H), to_torch(g)))
    # relative to the solution's scale: H's condition number amplifies
    # f32 rounding of the two factorisations
    np.testing.assert_allclose(t, j, atol=1e-5 * np.abs(j).max(), rtol=0)


@pytest.mark.parametrize("n", [4, 6])
def test_jacobi_eigh_matches_jax(rng, n):
    A = rng.normal(size=(n, n)).astype(np.float32)
    A = A @ A.T
    jw, jv = jlinalg.jacobi_eigh(jnp.asarray(A))
    tw, tv = tlinalg.jacobi_eigh(to_torch(A))
    scale = np.abs(np_(jw)).max()
    np.testing.assert_allclose(np_(tw), np_(jw), atol=1e-6 * scale, rtol=0)
    # eigenvectors up to sign
    dots = np.abs(np.sum(np_(tv) * np_(jv), axis=0))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# cloud
# ---------------------------------------------------------------------------

def _pts(rng, n=50):
    return (rng.normal(size=(n, 3)) * 4).astype(np.float32)


def _assert_cloud_equal(tc, jc, atol=0.0):
    for a, b in zip(tc, (jc.xyz, jc.normals, jc.intensity, jc.mask)):
        np.testing.assert_allclose(np_(a), np_(b), atol=atol, rtol=0)


@pytest.mark.parametrize("capacity", [30, 50, 64])
def test_cloud_from_points_matches(rng, capacity):
    xyz = _pts(rng)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    inten = rng.uniform(size=(50,)).astype(np.float32)
    mask = rng.uniform(size=(50,)) > 0.3
    j = jcloud.PointCloud.from_points(jnp.asarray(xyz), capacity, jnp.asarray(nrm), jnp.asarray(inten), jnp.asarray(mask))
    t = tcloud.PointCloud.from_points(xyz, capacity, nrm, inten, mask)
    _assert_cloud_equal(t, j)
    assert int(t.count()) == int(j.count())


def test_cloud_ops_match(rng):
    xyz = _pts(rng)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    mask = rng.uniform(size=(50,)) > 0.3
    j = jcloud.PointCloud.from_points(jnp.asarray(xyz), 64, jnp.asarray(nrm), mask=jnp.asarray(mask))
    t = tcloud.PointCloud.from_points(xyz, 64, nrm, mask=mask)
    keep = rng.uniform(size=(64,)) > 0.5
    _assert_cloud_equal(t.with_mask(to_torch(keep)), j.with_mask(jnp.asarray(keep)))
    T = _rand_pose(rng)
    _assert_cloud_equal(t.transform(to_torch(T)), j.transform(jnp.asarray(T)), atol=ATOL * 10)
    for cap in (None, 40):
        _assert_cloud_equal(t.compact(cap), j.compact(cap))
    np.testing.assert_allclose(np_(t.centroid()), np_(j.centroid()), atol=ATOL * 10, rtol=0)


def test_cloud_concatenate_matches(rng):
    parts_j, parts_t = [], []
    for n in (20, 30):
        xyz = _pts(rng, n)
        mask = rng.uniform(size=(n,)) > 0.4
        parts_j.append(jcloud.PointCloud.from_points(jnp.asarray(xyz), 32, mask=jnp.asarray(mask)))
        parts_t.append(tcloud.PointCloud.from_points(xyz, 32, mask=mask))
    for cap in (None, 48):
        _assert_cloud_equal(tcloud.concatenate(parts_t, cap), jcloud.concatenate(parts_j, cap))


def test_cloud_empty_matches():
    _assert_cloud_equal(tcloud.PointCloud.empty(16), jcloud.PointCloud.empty(16))
    assert tcloud.PAD_COORD == jcloud.PAD_COORD
    assert isinstance(tcloud.PointCloud.empty(4).xyz, torch.Tensor)
