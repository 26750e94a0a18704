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
import torch

from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.ops import voxel as jvoxel
from locus_tpu.ops.pallas import nn as jnn
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.ops.kernels import nn as tnn, raw_launches
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


def _lex_min(a, b):
    """(score, index) lexicographic minimum of two (d, i) results."""
    (da, ia), (db, ib) = a, b
    take = (db < da) | ((db == da) & (ib < ia))
    return torch.where(take, db, da), torch.where(take, ib, ia)


def _visit_case(rng, batch, bt, sub, num_chunks=4):
    """Operands and visit lists for nn_visits_plain over 4 query tiles,
    with a leading batch dimension when batch > 0. The first 64 targets of
    chunk 0 repeat at the start of the last chunk (exact score ties across
    chunks), and every 4th query lies near one of them. Visit lists are
    random, except that tile 0 visits every chunk, tile 1 none, and tile 2
    the last chunk but not chunk 0. Padding rows (+inf) fill the last range
    of `sub` targets."""
    lead = (batch,) if batch else ()
    nb, num_tiles = max(batch, 1), 4
    n_pad, m_pad = num_tiles * tnn.BQ, num_chunks * bt
    pts = rng.uniform(-5, 5, size=(nb, m_pad, 3)).astype(np.float32)
    last = (num_chunks - 1) * bt
    pts[:, last : last + 64] = pts[:, :64]
    q = rng.uniform(-5, 5, size=(nb, n_pad, 3)).astype(np.float32)
    q[:, ::4] = pts[:, :64] + rng.normal(scale=1e-3, size=(nb, 64, 3)).astype(np.float32)
    m = m_pad - sub - 88
    t_aug = tnn.build_nn_target(torch.from_numpy(pts[:, :m]).reshape(lead + (m, 3)), m_pad=m_pad, bt=bt)
    visit = rng.uniform(size=(nb, num_tiles, num_chunks)) < 0.6
    visit[:, 0], visit[:, 1] = True, False
    visit[:, 2, 0], visit[:, 2, -1] = False, True
    cnt = visit.sum(-1).astype(np.int32)
    ids = np.zeros((nb, num_tiles, num_chunks), np.int32)
    for b, g in np.ndindex(nb, num_tiles):
        ids[b, g, : cnt[b, g]] = np.nonzero(visit[b, g])[0]
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).reshape(lead + x.shape[1:])
    return as_t(cnt), as_t(ids.reshape(nb, -1)), tnn.pack_query(as_t(q)), t_aug


@pytest.mark.parametrize("batch", [0, 3], ids=["single", "batched"])
@pytest.mark.parametrize("bt,sub", [(512, 256), (2048, 512)])
def test_nn_visits_merge_of_slices_is_bit_exact(rng, bt, sub, batch):
    """The rule the B2/B3 kernel's split relies on: cut every tile's visit
    list into slices (one visited chunk, and within it one range of `sub`
    targets, the rest of the operand masked to +inf), run the plain version
    on each slice, and merge the results in a random order by (score,
    index) lexicographic minimum. The bits equal the full call's, exact
    ties across chunks and tiles with cnt = 0 included."""
    cnt, ids, q, t_aug = _visit_case(rng, batch, bt, sub)
    num_chunks = t_aug.shape[-2] // bt
    full_d, full_i = tnn.nn_visits_plain(cnt, ids, q, t_aug, bt)
    slot_ids = ids.reshape(cnt.shape + (num_chunks,))
    offset = torch.arange(t_aug.shape[-2]) % bt
    pieces = []
    for v in range(num_chunks):
        cnt_v = (cnt > v).to(torch.int32)
        ids_v = torch.zeros_like(slot_ids)
        ids_v[..., 0] = slot_ids[..., v]
        for r in range(bt // sub):
            t_r = t_aug.clone()
            out = (offset < r * sub) | (offset >= (r + 1) * sub)
            t_r[..., out, :3] = 0.0
            t_r[..., out, 3] = float("inf")
            pieces.append(tnn.nn_visits_plain(cnt_v, ids_v.flatten(-2), q, t_r, bt))
    merged = (torch.full_like(full_d, float("inf")), torch.zeros_like(full_i))
    for k in rng.permutation(len(pieces)):
        merged = _lex_min(merged, pieces[k])
    np.testing.assert_array_equal(np_(merged[0].view(torch.int32)), np_(full_d.view(torch.int32)))
    np.testing.assert_array_equal(np_(merged[1]), np_(full_i))
    # the cases the kernel must get right are present: a tie across chunks
    # won by the lower index (tile 0), the same targets won in the last
    # chunk where chunk 0 is not visited (tile 2), and a tile without
    # visits at (+inf, 0) (tile 1)
    near = full_i[..., 0 : 4 * tnn.BQ : 4].reshape(-1, 4, 16)
    np.testing.assert_array_equal(np_(near[:, 0]), np_(torch.arange(16).expand(near.shape[0], 16)))
    np.testing.assert_array_equal(np_(near[:, 2]), np_((torch.arange(32, 48) + (num_chunks - 1) * bt).expand(near.shape[0], 16)))
    assert bool(torch.isinf(full_d[..., tnn.BQ : 2 * tnn.BQ]).all())
    assert not bool(full_i[..., tnn.BQ : 2 * tnn.BQ].any())


@pytest.mark.parametrize("batch,num_tiles,num_chunks,bt", [
    (1, 64, 8, 512), (1, 64, 64, 2048), (4, 64, 8, 512), (4, 64, 64, 2048), (16, 64, 64, 2048),
    (16, 64, 8, 512), (2, 64, 64, 2048), (64, 64, 64, 2048),
])
def test_nn_visits_splits_from_the_shapes(batch, num_tiles, num_chunks, bt):
    """The B2/B3 grid: a tile's queries split over the most blocks (an
    instance of the kernel) that keep the grid within 2 blocks per SM;
    where that leaves one block per tile and a tile may hold more than
    SMALL_TARGET slices, its slices split over TARGET_SPLITS blocks."""
    sms = 132
    qs, ts = tnn.splits(batch, num_tiles, num_chunks, bt, sms)
    units = batch * num_tiles
    assert qs in tnn.QUERY_SPLITS
    assert qs == 1 or units * qs <= 2 * sms
    assert qs == max(tnn.QUERY_SPLITS) or units * qs * 2 > 2 * sms
    most = num_chunks * bt // tnn.SUB
    assert ts == (1 if qs > 1 or most <= tnn.SMALL_TARGET else min(most, tnn.TARGET_SPLITS))
    assert tnn.launch_grid(batch, num_tiles, num_chunks, bt, sms) == (num_tiles * qs, batch, ts)


def test_nn_visits_uses_plain_on_cpu():
    q, t, tm, r = _bounded_case(512, 300, 1024, 1.0, seed=7)
    before = raw_launches()
    t_aug = tnn.build_nn_target(to_torch(t), bt=512)
    tmin, tmax = tnn.chunk_boxes(to_torch(t), to_torch(tm), t_aug.shape[0], bt=512)
    tnn.nearest_bounded_pre(to_torch(q), t_aug, to_torch(t), tmin, tmax, r, bt=512)
    assert raw_launches() == before
