"""Map re-anchoring after a loop closure (`keyframe_map.reanchor`,
`voxel_hash_map.reanchor`) and the map snapshot, against the JAX package:
the same keyframes inserted in both, the same corrections applied.
Moved points and normals within 1e-5 (f32 products in another order),
the rebuilt 1-NN operand within 1e-4 relative (|t|^2 of moved points),
chunk boxes within 1e-5, voxel keys and slot provenance equal. After the
correction, the map's 1-NN (kernel B2's plain version on the CPU) returns
what a brute-force search over every stored point returns: the operand
and the chunk boxes were rebuilt (a stale box would prune true
neighbours without any error)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu.config import MapperConfig
from locus_tpu.core.cloud import PointCloud as JCloud
from locus_tpu.geometry import se3 as jse3
from locus_tpu.mapping import keyframe_map as jkm
from locus_tpu.mapping import voxel_hash_map as jvh
from locus_tpu_torch import config as tconfig
from locus_tpu_torch.core.cloud import PointCloud as TCloud
from locus_tpu_torch.io import pcd
from locus_tpu_torch.mapping import keyframe_map as tkm
from locus_tpu_torch.mapping import voxel_hash_map as tvh
from tests.torch_helpers import np_

MODULES = {"ring": (jkm, tkm), "voxel_hash": (jvh, tvh)}


def _corrections():
    """Keyframe 1 shifted 10 m sideways (out of its chunk's old box),
    keyframe 2 rotated and shifted."""
    corr = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    corr[1] = np.array(jse3.make_transform(jnp.eye(3), jnp.asarray([0.3, 10.0, 0.1])))
    corr[2] = np.array(jse3.make_transform(jse3.so3_exp(jnp.asarray([0.0, 0.0, 0.1])), jnp.asarray([-0.1, 0.4, 0.0])))
    return corr


KF_POINTS = 2048   # one BT chunk of the ring per keyframe


def _maps(structure, rng, keyframes=3):
    """The same keyframes inserted into the JAX and the port map: keyframe
    k is a blob of random points 20k m along x, so that on the ring each
    keyframe fills about one chunk and its box."""
    jm_mod, tm_mod = MODULES[structure]
    jcfg = MapperConfig(map_capacity=4 * KF_POINTS, keyframe_capacity=KF_POINTS, map_voxel_leaf=0.05,
                        structure=structure)
    tcfg = tconfig.MapperConfig(**dataclasses.asdict(jcfg))
    jm, tm = jm_mod.init_map(jcfg), tm_mod.init_map(tcfg, device="cpu")
    for k in range(keyframes):
        pts = (rng.normal(size=(KF_POINTS, 3)) * 2 + [20.0 * k, 0, 0]).astype(np.float32)
        nrm = rng.normal(size=(KF_POINTS, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        jm = jm_mod.insert_keyframe(jm, JCloud.from_points(pts, capacity=KF_POINTS, normals=nrm), jcfg)
        tm = tm_mod.insert_keyframe(tm, TCloud.from_points(pts, capacity=KF_POINTS, normals=nrm, device="cpu"), tcfg)
    return jm, tm, jcfg, tcfg


@pytest.mark.parametrize("structure", ["ring", "voxel_hash"])
def test_reanchor_matches_jax(structure, rng):
    jm_mod, tm_mod = MODULES[structure]
    jm, tm, jcfg, tcfg = _maps(structure, rng)
    np.testing.assert_array_equal(np_(tm.kf_index), np_(jm.kf_index))
    corr = _corrections()
    jr = jm_mod.reanchor(jm, jnp.asarray(corr), jcfg)
    tr = tm_mod.reanchor(tm, torch.as_tensor(corr), tcfg)
    np.testing.assert_array_equal(np_(tr.cloud.mask), np_(jr.cloud.mask))
    np.testing.assert_allclose(np_(tr.cloud.xyz), np_(jr.cloud.xyz), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(tr.cloud.normals), np_(jr.cloud.normals), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(tr.nn_aug), np_(jr.nn_aug)[:4].T, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np_(tr.chunk_min), np_(jr.chunk_min), atol=1e-5)
    np.testing.assert_allclose(np_(tr.chunk_max), np_(jr.chunk_max), atol=1e-5)
    if structure == "voxel_hash":
        np.testing.assert_array_equal(np_(tr.keys), np_(jr.keys))
    moved = np_(tm.kf_index) >= 1
    assert moved.any() and np.abs(np_(tr.cloud.xyz)[moved] - np_(tm.cloud.xyz)[moved]).min(axis=1).max() > 0


@pytest.mark.parametrize("structure", ["ring", "voxel_hash"])
def test_map_nearest_after_reanchor_equals_brute_force(structure, rng):
    _, tm_mod = MODULES[structure]
    _, tm, _, tcfg = _maps(structure, rng)
    tr = tm_mod.reanchor(tm, torch.as_tensor(_corrections()), tcfg)
    # queries near each keyframe's stored points, sorted along y in tiles
    # of 64 as a scan's are compact (keyframe 1's now lie up to 10 m from
    # where its chunk's old box was), and a tile beyond any stored point
    xyz, kf = np_(tr.cloud.xyz), np_(tr.kf_index)
    blocks = []
    for k in range(3):
        pts = xyz[kf == k]
        pick = pts[rng.choice(len(pts), 192)] + rng.normal(size=(192, 3)) * 0.3
        blocks.append(pick[np.argsort(pick[:, 1])])
    blocks.append(blocks[0][:64] + 100.0)
    q = np.concatenate(blocks).astype(np.float32)
    radius = 1.5
    d2, idx = tkm._map_nearest(tr, torch.as_tensor(q), radius)
    slot = np.nonzero(np_(tr.cloud.mask))[0]
    full = ((q[:, None, :].astype(np.float64) - xyz[slot][None]) ** 2).sum(-1)
    best = full.argmin(1)
    ref_d2 = full[np.arange(len(q)), best]
    hit = ref_d2 <= radius * radius
    got = np.isfinite(np_(d2))
    np.testing.assert_array_equal(got, hit)
    np.testing.assert_array_equal(np_(idx)[hit], slot[best[hit]])
    np.testing.assert_allclose(np_(d2)[hit], ref_d2[hit], rtol=1e-5, atol=1e-6)


def test_identity_correction_and_provenance_free_slots(rng):
    _, tm, _, tcfg = _maps("ring", rng, keyframes=2)
    same = tkm.reanchor(tm, torch.eye(4).expand(8, 4, 4), tcfg)
    torch.testing.assert_close(same.cloud.xyz, tm.cloud.xyz, rtol=0, atol=0)
    # a slot without provenance (a ground-truth map) never moves
    gt = tm._replace(kf_index=torch.full_like(tm.kf_index, -1))
    shift = torch.eye(4).repeat(2, 1, 1)
    shift[:, 0, 3] = 1.0
    torch.testing.assert_close(tkm.reanchor(gt, shift, tcfg).cloud.xyz, tm.cloud.xyz, rtol=0, atol=0)
    # keyframes beyond the table stay in place
    part = tkm.reanchor(tm, shift[:1], tcfg)
    kf1 = np_(tm.kf_index) == 1
    np.testing.assert_array_equal(np_(part.cloud.xyz)[kf1], np_(tm.cloud.xyz)[kf1])


@pytest.mark.parametrize("structure", ["ring", "voxel_hash"])
def test_snapshot_to_pcd(tmp_path, rng, structure):
    _, tm_mod = MODULES[structure]
    jm, tm, _, _ = _maps(structure, rng, keyframes=2)
    path = str(tmp_path / "map.pcd")
    n = tm_mod.snapshot_to_pcd(tm, path)
    jpath = str(tmp_path / "jmap.pcd")
    assert n == MODULES[structure][0].snapshot_to_pcd(jm, jpath) == int(tm.cloud.mask.sum())
    xyz, normals = pcd.read_pcd_xyz_normals(path)
    m = np_(tm.cloud.mask)
    np.testing.assert_array_equal(xyz, np_(tm.cloud.xyz)[m])
    np.testing.assert_array_equal(normals, np_(tm.cloud.normals)[m])
    np.testing.assert_array_equal(xyz, pcd.read_pcd_xyz_normals(jpath)[0])
