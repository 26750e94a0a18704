"""Kernel B2 (visit-list 1-NN) and its helpers against the JAX package.

The plain PyTorch version runs here; the JAX side runs its Pallas kernel
in interpret mode. Tolerances: operand and box helpers exact (the
operand's |t|^2 to 1 ulp); d2 within 1e-5 m^2 absolute; indices equal
except where the JAX winner's d2 ties the port's within 1e-5 (two targets
equally near within f32 rounding may win on either side). The CUDA
kernel itself is held against the plain version in test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.ops import voxel as jvoxel
from locus_tpu.ops.pallas import nn as jnn
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.ops.kernels import nn as tnn
from tests.torch_helpers import np_, to_torch

D2_ATOL = 1e-5


def _cloud(capacity, leaf, seed, shift=(0.0, 0.0, 0.0)):
    """A voxelised tunnel scan in sorted-voxel order (spatially coherent
    chunks, as the pipeline feeds the kernel), with sentinel padding."""
    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=512, step=0.3, seed=seed)
    xyz = seq.scans[0][seq.scan_valid[0]].astype(np.float32) + np.float32(shift)
    pc = JPC.from_points(jnp.asarray(xyz), capacity=max(capacity, xyz.shape[0]))
    pc = jvoxel.voxel_downsample(pc, leaf, capacity=capacity, with_attributes=False)
    return np.array(pc.xyz), np.array(pc.mask)


def test_build_and_update_nn_target_match(rng):
    xyz, mask = _cloud(1000, 0.1, 3)
    j = np_(jnn.build_nn_target(jnp.asarray(xyz), bt=512))
    t = np_(tnn.build_nn_target(to_torch(xyz), bt=512))
    assert t.shape == (j.shape[1], 4)
    np.testing.assert_array_equal(t[:, :3], j[:3].T)
    np.testing.assert_allclose(t[:, 3], j[3], rtol=2e-7, atol=0)
    np.testing.assert_array_equal(j[4:], 0.0)

    idx = rng.integers(0, 1024, size=64).astype(np.int32)
    idx = np.unique(idx)
    pts = (rng.normal(size=(idx.size, 3)) * 2).astype(np.float32)
    valid = rng.uniform(size=idx.size) > 0.3
    ju = np_(jnn.update_nn_target(jnp.asarray(j), jnp.asarray(idx), jnp.asarray(pts), jnp.asarray(valid)))
    tu = np_(tnn.update_nn_target(to_torch(t), to_torch(idx), to_torch(pts), to_torch(valid)))
    np.testing.assert_array_equal(tu[:, :3], ju[:3].T)
    np.testing.assert_allclose(tu[:, 3], ju[3], rtol=2e-7, atol=0)


@pytest.mark.parametrize("bt", [512, 2048])
def test_chunk_boxes_and_update_match(rng, bt):
    xyz, mask = _cloud(4096, 0.1, 4)
    jmin, jmax = jnn.chunk_boxes(jnp.asarray(xyz), jnp.asarray(mask), bt=bt)
    tmin, tmax = tnn.chunk_boxes(to_torch(xyz), to_torch(mask), bt=bt)
    np.testing.assert_array_equal(np_(tmin), np_(jmin))
    np.testing.assert_array_equal(np_(tmax), np_(jmax))
    if bt != jnn.BT:
        return  # update_chunk_boxes works on the map's BT chunks
    idx = rng.integers(0, 4096, size=100).astype(np.int32)
    pts = (rng.normal(size=(100, 3)) * 20).astype(np.float32)
    valid = rng.uniform(size=100) > 0.3
    ja = jnn.update_chunk_boxes(jmin, jmax, jnp.asarray(idx), jnp.asarray(pts), jnp.asarray(valid))
    ta = tnn.update_chunk_boxes(tmin, tmax, to_torch(idx), to_torch(pts), to_torch(valid))
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(np_(a), np_(b))


def _bounded_case(bt, n_query, m, radius, seed):
    leaf = 0.1 if bt == 512 else 0.05
    q, qm = _cloud(n_query, 0.2, seed + 1, shift=(0.1, -0.05, 0.02))
    q[~qm] = 1e8
    t, tm = _cloud(m, leaf, seed)
    return q, t, tm, radius


@pytest.mark.parametrize("bt,n_query,m,radius", [(512, 700, 2048, 1.0), (2048, 700, 8192, 2.0), (512, 300, 1536, 0.3)])
def test_nearest_bounded_pre_matches_pallas(bt, n_query, m, radius):
    q, t, tm, r = _bounded_case(bt, n_query, m, radius, seed=5)
    j_aug = jnn.build_nn_target(jnp.asarray(t), bt=bt)
    jmin, jmax = jnn.chunk_boxes(jnp.asarray(t), jnp.asarray(tm), j_aug.shape[1], bt=bt)
    jd, ji = jnn.nearest_pallas_bounded_pre(
        jnp.asarray(q), j_aug, jnp.asarray(t), jmin, jmax, r, interpret=True, bt=bt
    )
    t_aug = tnn.build_nn_target(to_torch(t), bt=bt)
    tmin, tmax = tnn.chunk_boxes(to_torch(t), to_torch(tm), t_aug.shape[0], bt=bt)
    td, ti = tnn.nearest_bounded_pre(to_torch(q), t_aug, to_torch(t), tmin, tmax, r, bt=bt)
    jd, ji, td, ti = np_(jd), np_(ji), np_(td), np_(ti)

    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    f = np.isfinite(jd)
    assert f.sum() > 0.5 * len(f)
    np.testing.assert_allclose(td[f], jd[f], atol=D2_ATOL, rtol=0)
    # indices: equal, or the two winners tie within the d2 tolerance
    diff = f & (ti != ji)
    d2_port_at_jax = np.sum((q[diff] - t[ji[diff]]) ** 2, axis=1)
    np.testing.assert_allclose(d2_port_at_jax, td[diff], atol=D2_ATOL, rtol=0)


def test_visit_lists_exact_against_brute_force():
    """Every target within the radius of a valid query lies in a chunk
    its tile visits (the pruning may only skip chunks that cannot hold a
    neighbour), and ids are each tile's visited chunks in ascending
    order."""
    q, t, tm, r = _bounded_case(512, 700, 2048, 0.5, seed=6)
    tq, tt = to_torch(q), to_torch(t)
    cmin, cmax = tnn.chunk_boxes(tt, to_torch(tm), bt=512)
    tmin, tmax = tnn.tile_boxes(tq)
    cnt, ids = tnn.visit_lists(tmin, tmax, cmin, cmax, r * r)
    visit = np_(tnn.visited_mask(cnt, ids, cmin.shape[0]))
    cnt, ids = np_(cnt), np_(ids).reshape(cnt.shape[0], -1)
    for g in range(cnt.shape[0]):
        np.testing.assert_array_equal(ids[g, : cnt[g]], np.nonzero(visit[g])[0])
    qv = np.all(np.abs(q) < 1e7, axis=1)
    d2 = ((q[:, None, :].astype(np.float64) - t[None].astype(np.float64)) ** 2).sum(-1)
    qi, ti = np.nonzero((d2 <= r * r) & qv[:, None] & tm[None])
    assert qi.size > 0
    assert visit[qi // tnn.BQ, ti // 512].all()
    assert visit.mean() < 0.6  # the pruning does skip chunks


def test_nn_visits_uses_plain_on_cpu():
    q, t, tm, r = _bounded_case(512, 300, 1024, 1.0, seed=7)
    before = dict(tnn.launches)
    t_aug = tnn.build_nn_target(to_torch(t), bt=512)
    tmin, tmax = tnn.chunk_boxes(to_torch(t), to_torch(tm), t_aug.shape[0], bt=512)
    tnn.nearest_bounded_pre(to_torch(q), t_aug, to_torch(t), tmin, tmax, r, bt=512)
    assert tnn.launches == before
