"""The port's voxel-hash map against `locus_tpu.mapping.voxel_hash_map`: the
same inserts, refreshes and queries in lockstep, on the fixtures of
tests/test_mapping.py.

Tolerances: slot indices bit for bit (negative, far and wrapping voxel
coordinates included); after every insert the keys, occupancy, masks,
keyframe provenance and chunk boxes exactly, stored points and normals
exactly (an insert only moves them), the cached operand's |t|^2 to 1 ulp.
Inserts include many points of one new voxel (one slot written several
times in one scatter: the last write wins in both) and collisions of
different voxels in a small table. ANN: the stores hold a dedup of the
same keyframe, so the nearest distances agree with the ring map's within
two map leaves, as tests/test_mapping.py holds JAX's, and with JAX's
voxel-hash ANN within 1e-4 m^2 (the ring test's tolerance, see
tests/test_torch_mapping.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import pipeline as jpl
from locus_tpu.config import LocusConfig as JLC, MapperConfig as JMC
from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.mapping import voxel_hash_map as jvh
from locus_tpu_torch.config import MapperConfig as TMC
from locus_tpu_torch.convert import state_from_numpy
from locus_tpu_torch.mapping import keyframe_map as tkm, voxel_hash_map as tvh
from locus_tpu_torch.mapping.registry import mapper_fabric
from tests.torch_helpers import np_, torch_cloud

CFG = dict(map_capacity=1024, keyframe_capacity=128, map_voxel_leaf=0.1)


def grid_cloud(offset=0.0, n=64, capacity=128, dup=0, seed=None):
    """n points in a 5 m box; `dup` extra points sharing the voxels of the
    first ones (several writes to one slot in one insert)."""
    rng = np.random.default_rng(abs(int(offset * 100)) + 1 if seed is None else seed)
    pts = (rng.uniform(0, 5, size=(n, 3)) + offset).astype(np.float32)
    if dup:
        leaf = CFG["map_voxel_leaf"]
        base = (np.floor(pts[:dup] / leaf) + 0.5) * leaf
        pts = np.concatenate([pts, (base + rng.uniform(-0.3, 0.3, size=(dup, 3)) * leaf).astype(np.float32)])
    nrm = rng.normal(size=(pts.shape[0], 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return JPC.from_points(jnp.asarray(pts), capacity=capacity, normals=jnp.asarray(nrm))


def assert_maps_match(t, j):
    for f in ("keys", "occupied", "num_keyframes", "kf_index", "chunk_min", "chunk_max", "last_refresh_position"):
        np.testing.assert_array_equal(np_(getattr(t, f)), np_(getattr(j, f)), err_msg=f)
    for f in ("xyz", "normals", "intensity", "mask"):
        np.testing.assert_array_equal(np_(getattr(t.cloud, f)), np_(getattr(j.cloud, f)), err_msg=f)
    ja, ta = np_(j.nn_aug), np_(t.nn_aug)
    np.testing.assert_array_equal(ta[:, :3], ja[:3].T)
    np.testing.assert_allclose(ta[:, 3], ja[3], rtol=2e-7, atol=0)
    assert int(tvh.map_size(t)) == int(jvh.map_size(j))


def _both(cfg_kw):
    jc, tc = JMC(**cfg_kw), TMC(**cfg_kw)
    return jc, tc, jvh.init_map(jc), tvh.init_map(tc, device="cpu")


def test_slots_bit_equal():
    rng = np.random.default_rng(5)
    ijk = np.concatenate([
        rng.integers(-2000, 2000, size=(2000, 3)),
        rng.integers(-(1 << 30), 1 << 30, size=(2000, 3)),       # products wrap at 32 bits
        [[0, 0, 0], [-1, -1, -1], [1 << 20, -(1 << 20), 7], [-(1 << 31), 0, 0], [(1 << 31) - 1, 3, -5]],
    ]).astype(np.int32)
    for cap in (1024, 131072, 1000, 7):
        t = np_(tvh._slot_of(torch.tensor(ijk), cap))
        j = np_(jvh._slot_of(jnp.asarray(ijk), cap))
        np.testing.assert_array_equal(t, j)
        assert t.min() >= 0 and t.max() < cap


def test_slot_of_int32_min():
    """A hash equal to INT32_MIN: int32 abs leaves it negative and the floor
    modulo maps it into the table (the case a plain int64 abs would get
    wrong for a capacity that does not divide 2^31)."""
    # i * P1 wraps to INT32_MIN for i = inverse(P1) * 2^31 mod 2^32; j = k = 0
    inv = pow(tvh._P1, -1, 1 << 32)
    i = (inv * (1 << 31)) % (1 << 32)
    i = i - (1 << 32) if i >= (1 << 31) else i
    ijk = np.array([[i, 0, 0]], np.int32)
    assert int(np_(tvh._wrap32(torch.tensor(ijk, dtype=torch.int64)[:, 0] * tvh._P1))[0]) == -(1 << 31)
    for cap in (1000, 12345, 131072):
        np.testing.assert_array_equal(np_(tvh._slot_of(torch.tensor(ijk), cap)), np_(jvh._slot_of(jnp.asarray(ijk), cap)))


@pytest.mark.parametrize("seq", [
    ((0.0, 0),), ((0.0, 0), (0.0, 0)), ((0.0, 40), (0.05, 40), (10.0, 0)), ((-7.3, 30), (-7.3, 30), (-120.0, 10)),
])
@pytest.mark.parametrize("capacity", [1024, 96])
def test_inserts_match(seq, capacity):
    """Inserts with in-voxel duplicates; at capacity 96 most voxels collide."""
    kw = dict(CFG, map_capacity=capacity)
    jc, tc, j, t = _both(kw)
    for off, dup in seq:
        kf = grid_cloud(off, dup=dup)
        j = jvh.insert_keyframe(j, kf, jc)
        t = tvh.insert_keyframe(t, torch_cloud(kf), tc)
        assert_maps_match(t, j)


def test_duplicate_writes_take_the_last():
    """Every point of one new voxel writes its slot in one insert; the
    stored point is the last of them, in both."""
    leaf = CFG["map_voxel_leaf"]
    pts = (np.array([[1.0, 2.0, 3.0]]) + 0.5 * leaf + np.linspace(-0.3, 0.3, 9)[:, None] * leaf).astype(np.float32)
    kf = JPC.from_points(jnp.asarray(pts), capacity=16)
    jc, tc, j, t = _both(CFG)
    j = jvh.insert_keyframe(j, kf, jc)
    t = tvh.insert_keyframe(t, torch_cloud(kf), tc)
    assert_maps_match(t, j)
    m = np_(t.cloud.mask)
    assert m.sum() == 1
    np.testing.assert_array_equal(np_(t.cloud.xyz)[m][0], pts[-1])


def test_refresh_and_disabled_calls_match():
    jc, tc, j, t = _both(CFG)
    for off in (0.0, 100.0):
        j = jvh.insert_keyframe(j, grid_cloud(off, dup=10), jc)
        t = tvh.insert_keyframe(t, torch_cloud(grid_cloud(off, dup=10)), tc)
    pos = np.array([2.5, 2.5, 2.5], np.float32)
    j = jvh.refresh_msw(j, jnp.asarray(pos), jc)
    t = tvh.refresh_msw(t, torch.as_tensor(pos), tc)
    assert_maps_match(t, j)
    assert 0 < int(tvh.map_size(t)) < 128
    # the freed slots are reused
    j = jvh.insert_keyframe(j, grid_cloud(100.0), jc)
    t = tvh.insert_keyframe(t, torch_cloud(grid_cloud(100.0)), tc)
    assert_maps_match(t, j)
    off = torch.tensor(False)
    for t2 in (tvh.insert_keyframe(t, torch_cloud(grid_cloud(3.0)), tc, enabled=off),
               tvh.refresh_msw(t, torch.tensor([500.0, 0.0, 0.0]), tc, enabled=off)):
        assert_maps_match(t2, j)


def test_ann_matches_ring_and_jax():
    jc, tc = JMC(**CFG), TMC(**CFG)
    kf = grid_cloud()
    ring = tkm.insert_keyframe(tkm.init_map(tc, device="cpu"), torch_cloud(kf), tc)
    hsh = tvh.insert_keyframe(tvh.init_map(tc, device="cpu"), torch_cloud(kf), tc)
    jh = jvh.insert_keyframe(jvh.init_map(jc), kf, jc)
    q = grid_cloud(0.5)
    _, d2_r = tkm.approx_nearest_neighbors(ring, torch_cloud(q), return_d2=True)
    nb_h, d2_h = tvh.approx_nearest_neighbors(hsh, torch_cloud(q), return_d2=True)
    jnb, jd2 = jvh.approx_nearest_neighbors(jh, q, return_d2=True)
    d2_r, d2_h = np_(d2_r), np_(d2_h)
    finite = np.isfinite(d2_r) & np.isfinite(d2_h)
    assert finite.sum() > 50
    assert np.abs(np.sqrt(d2_r[finite]) - np.sqrt(d2_h[finite])).max() < 2 * CFG["map_voxel_leaf"]
    np.testing.assert_array_equal(np_(nb_h.mask), np_(jnb.mask))
    m = np_(jnb.mask)
    np.testing.assert_allclose(d2_h[m], np_(jd2)[m], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np_(nb_h.xyz)[m], np_(jnb.xyz)[m])


def test_registry_and_state_conversion():
    assert mapper_fabric("voxel_hash") is tvh
    assert mapper_fabric(TMC(structure="voxel_hash")) is tvh
    jcfg = JLC(scan_capacity=256, raw_scan_capacity=1024,
               mapper=dataclasses.replace(JMC(**CFG), structure="voxel_hash"))
    jst = jpl.init_state(jcfg, initial_pose=jnp.eye(4))
    jst = jst._replace(map=jvh.insert_keyframe(jst.map, grid_cloud(dup=20), jcfg.mapper))
    tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    assert isinstance(tst.map, tvh.HashMapState)
    assert_maps_match(tst.map, jst.map)
