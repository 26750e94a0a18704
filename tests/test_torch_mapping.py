"""The ring map of the port against `locus_tpu.mapping.keyframe_map`: the
same inserts, refreshes and queries in lockstep, on the fixtures of
tests/test_mapping.py. Tolerances: masks, pointers, counters, keyframe
provenance and chunk boxes exact; coordinates within 1e-6 m; the cached
operand's |t|^2 to 1 ulp (its row layout differs: (8, m_pad) in JAX,
(m_pad, 4) here); ANN distances within 1e-4 m^2 (see the test)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu.config import MapperConfig as JMC
from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.mapping import keyframe_map as jkm
from locus_tpu_torch.config import MapperConfig as TMC
from locus_tpu_torch.mapping import keyframe_map as tkm
from locus_tpu_torch.mapping.registry import mapper_fabric
from tests.torch_helpers import np_, to_torch, torch_cloud

CFG = dict(map_capacity=1024, keyframe_capacity=128, map_voxel_leaf=0.1)


def grid_cloud(offset=0.0, n=64, capacity=128):
    rng = np.random.default_rng(int(offset * 100) + 1)
    pts = (rng.uniform(0, 5, size=(n, 3)) + offset).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return JPC.from_points(jnp.asarray(pts), capacity=capacity, normals=jnp.asarray(nrm))


def assert_maps_match(t, j):
    m = np_(j.cloud.mask)
    np.testing.assert_array_equal(np_(t.cloud.mask), m)
    np.testing.assert_allclose(np_(t.cloud.xyz), np_(j.cloud.xyz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_(t.cloud.normals), np_(j.cloud.normals), atol=1e-6, rtol=0)
    for f in ("write_ptr", "num_keyframes", "kf_index", "chunk_min", "chunk_max"):
        np.testing.assert_array_equal(np_(getattr(t, f)), np_(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(np_(t.last_refresh_position), np_(j.last_refresh_position))
    ja, ta = np_(j.nn_aug), np_(t.nn_aug)
    assert ta.shape == (ja.shape[1], 4)
    np.testing.assert_allclose(ta[:, :3], ja[:3].T, atol=2e-6, rtol=0)
    np.testing.assert_allclose(ta[:, 3], ja[3], rtol=2e-7, atol=0)
    assert int(tkm.map_size(t)) == int(jkm.map_size(j))


def _both(cfg_kw):
    jc, tc = JMC(**cfg_kw), TMC(**cfg_kw)
    return jc, tc, jkm.init_map(jc), tkm.init_map(tc, device="cpu")


def test_init_map_matches():
    _, _, j, t = _both(CFG)
    assert_maps_match(t, j)


@pytest.mark.parametrize("offsets", [(0.0,), (0.0, 0.0), (0.0, 10.0), (0.0, 0.05, 2.5)])
def test_insert_keyframes_match(offsets):
    jc, tc, j, t = _both(CFG)
    for off in offsets:
        kf = grid_cloud(off)
        j = jkm.insert_keyframe(j, kf, jc)
        t = tkm.insert_keyframe(t, torch_cloud(kf), tc)
        assert_maps_match(t, j)


def test_insert_with_precomputed_distances_matches(rng):
    jc, tc, j, t = _both(CFG)
    j = jkm.insert_keyframe(j, grid_cloud(0.0), jc)
    t = tkm.insert_keyframe(t, torch_cloud(grid_cloud(0.0)), tc)
    kf = grid_cloud(1.0)
    d2 = rng.uniform(0, 0.05, size=128).astype(np.float32)
    j = jkm.insert_keyframe(j, kf, jc, nearest_d2=jnp.asarray(d2))
    t = tkm.insert_keyframe(t, torch_cloud(kf), tc, nearest_d2=to_torch(d2))
    assert_maps_match(t, j)


def test_ring_overwrite_and_pointer_restart_match():
    kw = dict(map_capacity=256, keyframe_capacity=128, map_voxel_leaf=0.01)
    jc, tc, j, t = _both(kw)
    for i in range(6):
        kf = grid_cloud(10.0 * i, n=100)
        j = jkm.insert_keyframe(j, kf, jc)
        t = tkm.insert_keyframe(t, torch_cloud(kf), tc)
        assert_maps_match(t, j)


def test_msw_refresh_matches():
    kw = dict(CFG, box_filter_size=20.0)
    jc, tc, j, t = _both(kw)
    for off in (0.0, 50.0):
        j = jkm.insert_keyframe(j, grid_cloud(off), jc)
        t = tkm.insert_keyframe(t, torch_cloud(grid_cloud(off)), tc)
    pos = np.asarray([52.0, 52.0, 52.0], np.float32)
    j = jkm.refresh_msw(j, jnp.asarray(pos), jc)
    t = tkm.refresh_msw(t, to_torch(pos), tc)
    assert_maps_match(t, j)
    assert 0 < int(tkm.map_size(t)) < 128


@pytest.mark.parametrize("radius", [0.5, 2.0])
def test_approx_nearest_neighbors_match(radius):
    jc, tc, j, t = _both(CFG)
    for off in (0.0, 3.0):
        j = jkm.insert_keyframe(j, grid_cloud(off), jc)
        t = tkm.insert_keyframe(t, torch_cloud(grid_cloud(off)), tc)
    rng = np.random.default_rng(5)
    q = JPC.from_points(jnp.asarray(rng.uniform(-1, 9, size=(200, 3)).astype(np.float32)), capacity=256)
    jn, jd = jkm.approx_nearest_neighbors(j, q, return_d2=True, radius=radius)
    tn, td = tkm.approx_nearest_neighbors(t, torch_cloud(q), return_d2=True, radius=radius)
    m = np_(jn.mask)
    np.testing.assert_array_equal(np_(tn.mask), m)
    assert 0 < m.sum() < 200
    np.testing.assert_allclose(np_(tn.xyz), np_(jn.xyz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_(tn.normals), np_(jn.normals), atol=1e-6, rtol=0)
    # JAX's CPU path takes d2 from the expanded |q|^2+|t|^2-2q.t form, which
    # loses a few ulp of |q|^2+|t|^2 (~4e-5 m^2 at 8 m); the port
    # recomputes d2 from the coordinates
    np.testing.assert_allclose(np_(td)[m], np_(jd)[m], atol=1e-4, rtol=0)


def test_disabled_insert_and_refresh_are_noops():
    jc, tc, j, t = _both(CFG)
    t = tkm.insert_keyframe(t, torch_cloud(grid_cloud(0.0)), tc)
    j = jkm.insert_keyframe(j, grid_cloud(0.0), jc)
    off = torch.tensor(False)
    for state in (t, t._replace(write_ptr=torch.tensor(CFG["map_capacity"] - 10, dtype=torch.int32))):
        t2 = tkm.insert_keyframe(state, torch_cloud(grid_cloud(10.0)), tc, enabled=off)
        t3 = tkm.refresh_msw(state, torch.tensor([1000.0, 0.0, 0.0]), tc, enabled=off)
        for a, b in zip(t2, state):
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
        for f in ("cloud", "nn_aug", "last_refresh_position", "write_ptr"):
            a, b = getattr(t3, f), getattr(state, f)
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
    j2 = jkm.insert_keyframe(j, grid_cloud(10.0), jc, enabled=jnp.asarray(False))
    assert_maps_match(tkm.insert_keyframe(t, torch_cloud(grid_cloud(10.0)), tc, enabled=off), j2)


def test_mapper_fabric():
    from locus_tpu_torch.mapping import voxel_hash_map

    assert mapper_fabric(TMC()) is tkm
    assert mapper_fabric("ring") is tkm
    assert mapper_fabric("voxel_hash") is voxel_hash_map
    with pytest.raises(ValueError):
        mapper_fabric("octree3000")
