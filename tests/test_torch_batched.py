"""The batched kernels' plain versions and the batched ops of the port.

(a) Kernels B3/B4 (plain versions) against the JAX package's vmapped
    `nearest_pallas_bounded_pre` / `radius_moments_pallas_pruned_comps`
    in interpret mode (their custom-vmap rules lower to the batched Pallas
    kernels), and B5/B6 against `radius_moments_pallas_comps` and its
    vmap, at tests/test_pallas_batched.py's sizes (B = 3, N = 512,
    M = 4096) with per-member radii. Tolerances as in test_torch_nn.py and
    test_torch_moments.py: d2 within 1e-5 m^2, indices equal or tied
    within it; counts exact off the radius boundary, sums rtol 1e-5 with a
    floor of 1e-6 of the column's largest term.
(b) Every batched function against a loop of its single call: exact
    (bitwise). The batched path sums in the same order as the single one.
The CUDA kernels themselves are held against the plain versions in
test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu.ops.pallas import moments as jmom, nn as jnn
from locus_tpu_torch.config import MapperConfig, RegistrationConfig
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.io import synthetic
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.mapping import keyframe_map as tkm
from locus_tpu_torch.ops import normals as tnorm, voxel as tvoxel
from locus_tpu_torch.ops.kernels import moments as tmom, nn as tnn, raw_launches
from locus_tpu_torch.pipeline import member, stack_states
from locus_tpu_torch.registration.gicp import gicp_register
from tests.torch_helpers import np_, to_torch

D2_ATOL = 1e-5
RADII = [0.5, 0.8, 1.1]


@pytest.fixture(scope="module")
def clouds():
    """tests/test_pallas_batched.py's clouds: B = 3, N = 512, M = 4096."""
    rng = np.random.default_rng(3)
    qs = (rng.normal(size=(3, 512, 3)) * 5).astype(np.float32)
    ts = (rng.normal(size=(3, 4096, 3)) * 5).astype(np.float32)
    return qs, ts


def _assert_same(a, b):
    """Bitwise equality of two (nested) results."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np_(a), np_(b))


def _members(fn, *batched):
    """fn applied to each member of the batched arguments, stacked."""
    size = len(batched[0][0]) if isinstance(batched[0], tuple) else batched[0].shape[0]
    return stack_states([fn(*(member(x, b) for x in batched)) for b in range(size)])


# -- (a) the kernels' plain versions against JAX ----------------------------

@pytest.mark.parametrize("bt", [tnn.SCAN_BT, tnn.BT])
def test_batched_nn_matches_vmapped_pallas(clouds, bt):
    qs, ts = clouds
    radius = 2.0

    def jf(q, t):
        ta = jnn.build_nn_target(t, bt=bt)
        c_min, c_max = jnn.chunk_boxes(t, jnp.ones(t.shape[0], bool), ta.shape[1], bt=bt)
        return jnn.nearest_pallas_bounded_pre(q, ta, t, c_min, c_max, radius, interpret=True, bt=bt)

    jd, ji = (np_(x) for x in jax.vmap(jf)(jnp.asarray(qs), jnp.asarray(ts)))
    q, t = to_torch(qs), to_torch(ts)
    t_aug = tnn.build_nn_target(t, bt=bt)
    c_min, c_max = tnn.chunk_boxes(t, torch.ones(t.shape[:2], dtype=torch.bool), t_aug.shape[-2], bt=bt)
    before = raw_launches()
    td, ti = (np_(x) for x in tnn.nearest_bounded_pre(q, t_aug, t, c_min, c_max, radius, bt=bt))
    assert raw_launches() == before  # CPU tensors: the plain version

    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    f = np.isfinite(jd)
    assert 0.3 < f.mean() < 1.0
    np.testing.assert_allclose(td[f], jd[f], atol=D2_ATOL, rtol=0)
    for b in range(3):
        diff = f[b] & (ti[b] != ji[b])
        d2_at_jax = np.sum((qs[b][diff] - ts[b][ji[b][diff]]) ** 2, axis=1)
        np.testing.assert_allclose(d2_at_jax, td[b][diff], atol=D2_ATOL, rtol=0)


def _raw_sums(count, mean, cov):
    """(..., n, 10) raw moment sums rebuilt in float64 from component form."""
    n = np.asarray(count, np.float64)
    m = [np.asarray(c, np.float64) for c in mean]
    cxx, cxy, cxz, cyy, cyz, czz = (np.asarray(v, np.float64) for v in cov)
    second = [cxx + m[0] * m[0], cyy + m[1] * m[1], czz + m[2] * m[2],
              cxy + m[0] * m[1], cxz + m[0] * m[2], cyz + m[1] * m[2]]
    return np.stack([n * v for v in m] + [n * v for v in second] + [n], axis=-1)


def _boundary(qs, ts, radii):
    """(B, N): a query with a target within 1e-5 r of the radius r (float64)."""
    d = np.sqrt(((qs[:, :, None].astype(np.float64) - ts[:, None].astype(np.float64)) ** 2).sum(-1))
    r = np.asarray(radii, np.float64)[:, None, None]
    return np.any(np.abs(d - r) <= 1e-5 * r, axis=-1)


def _assert_moments_close(t_comps, j_comps, boundary):
    ts = _raw_sums(np_(t_comps[0]), [np_(v) for v in t_comps[1]], [np_(v) for v in t_comps[2]])
    js = _raw_sums(np_(j_comps[0]), [np_(v) for v in j_comps[1]], [np_(v) for v in j_comps[2]])
    same = ~boundary
    np.testing.assert_array_equal(ts[same][:, 9], js[same][:, 9])
    assert js[same][:, 9].sum() > 0
    scale = np.abs(js[same]).max(axis=0)
    err = np.abs(ts[same] - js[same])
    assert np.all(err <= 1e-5 * np.abs(js[same]) + 1e-6 * scale), err.max(axis=0)


def test_batched_pruned_moments_match_vmapped_pallas(clouds):
    """B4's plain version, one radius per member."""
    qs, ts = clouds
    radii = np.asarray(RADII, np.float32)
    j = jax.vmap(lambda q, t, r: jmom.radius_moments_pallas_pruned_comps(q, t, r, interpret=True))(
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(radii)
    )
    before = raw_launches()
    t = tmom.radius_moments_pruned_comps(to_torch(qs), to_torch(ts), to_torch(radii))
    assert raw_launches() == before
    _assert_moments_close(t, j, _boundary(qs, ts, radii))


def test_dense_moments_match_pallas(clouds):
    """B5's plain version against `radius_moments_pallas_comps`, one
    member, and B6's against its vmap."""
    qs, ts = clouds
    radii = np.asarray(RADII, np.float32)
    boundary = _boundary(qs, ts, radii)
    j1 = jmom.radius_moments_pallas_comps(jnp.asarray(qs[0]), jnp.asarray(ts[0]), radii[0], interpret=True)
    t1 = tmom.radius_moments_comps(to_torch(qs[0]), to_torch(ts[0]), to_torch(radii[0]))
    _assert_moments_close(t1, j1, boundary[0])
    jb = jax.vmap(lambda q, t, r: jmom.radius_moments_pallas_comps(q, t, r, interpret=True))(
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(radii)
    )
    tb = tmom.radius_moments_comps(to_torch(qs), to_torch(ts), to_torch(radii))
    _assert_moments_close(tb, jb, boundary)
    # the dense form: the same neighbourhoods as (count, mean, cov)
    count, mean, cov = tmom.radius_moments(to_torch(qs), to_torch(ts), to_torch(radii))
    _assert_same((count, mean[..., 0], cov[..., 1, 2]), (tb[0], tb[1][0], tb[2][4]))


# (queries, targets, radius of each member): shapes at the edges of B5/B6's
# tiling. The first member also runs alone (B5); all run batched (B6).
DENSE_EDGES = {
    "targets_not_a_multiple_of_1024": (128, 1500, (0.8, 0.6)),
    "queries_not_a_multiple_of_64": (100, 2048, (0.8, 0.6)),
    "one_chunk": (64, 1024, (0.8, 1.1)),
    "five_chunks": (192, 5000, (0.8, 0.5)),
    "radius_holds_every_pair": (128, 1100, (100.0, 100.0)),
    "radius_zero": (128, 1100, (0.0, 0.0)),
    "three_members_three_radii": (100, 1500, (0.5, 0.8, 1.1)),
}


@pytest.mark.parametrize("case", list(DENSE_EDGES))
def test_dense_moments_match_pallas_at_edge_shapes(case):
    """B5's plain version against `radius_moments_pallas_comps` (interpret
    mode) on the first member, and B6's against its vmap on all, at the
    edges of the tiling: padding targets (|t|^2 = PAD_T2), padding query
    rows, one and five 1024-point chunks, a radius that holds every pair,
    radius 0, three members with three radii. The queries are jittered
    copies of targets, a quarter of them exact. Tolerance as in
    `_assert_moments_close`: counts exact off the radius boundary (at
    radius 0 those counts are all 0), sums rtol 1e-5 with a floor of 1e-6
    of the column's largest term."""
    n, m, radii = DENSE_EDGES[case]
    rng = np.random.default_rng(7)
    ts = (rng.normal(size=(len(radii), m, 3)) * 2).astype(np.float32)
    qs = ts[:, rng.choice(m, n, replace=False)].copy()
    qs[:, n // 4:] += rng.normal(scale=0.1, size=qs[:, n // 4:].shape).astype(np.float32)
    radii = np.asarray(radii, np.float32)
    boundary = _boundary(qs, ts, radii)
    j1 = jmom.radius_moments_pallas_comps(jnp.asarray(qs[0]), jnp.asarray(ts[0]), radii[0], interpret=True)
    t1 = tmom.radius_moments_comps(to_torch(qs[0]), to_torch(ts[0]), to_torch(radii[0]))
    jb = jax.vmap(lambda q, t, r: jmom.radius_moments_pallas_comps(q, t, r, interpret=True))(
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(radii)
    )
    tb = tmom.radius_moments_comps(to_torch(qs), to_torch(ts), to_torch(radii))
    assert tb[0].shape == (len(radii), n)
    for t_comps, j_comps, bnd in ((t1, j1, boundary[0]), (tb, jb, boundary)):
        if radii[0] > 0:
            _assert_moments_close(t_comps, j_comps, bnd)
        else:
            assert bnd.any() and not np_(t_comps[0])[~bnd].any() and not np.asarray(j_comps[0])[~bnd].any()
    if case == "radius_holds_every_pair":
        np.testing.assert_array_equal(np_(tb[0]), m)


def test_dense_equals_pruned_off_the_boundary(clouds):
    """B5/B6 are the dense check of B1/B4: equal sums (float64, order
    free) wherever the counts agree, which is everywhere off the radius."""
    qs, ts = clouds
    radii = to_torch(np.asarray(RADII, np.float32))
    q, t = to_torch(qs), to_torch(ts)
    pruned = tmom.radius_moments_pruned_comps(q, t, radii)
    dense = tmom.radius_moments_comps(q, t, radii)
    same = ~_boundary(qs, ts, RADII)
    for a, b in zip(jax.tree_util.tree_leaves(pruned), jax.tree_util.tree_leaves(dense)):
        np.testing.assert_array_equal(np_(a)[same], np_(b)[same])


# -- (b) batched against a loop of single calls, exactly -------------------

def test_batched_kernel_plain_versions_equal_single_loop(clouds):
    qs, ts = clouds
    q, t = to_torch(qs), to_torch(ts)
    r2 = to_torch(np.asarray(RADII, np.float32) ** 2)

    def nn_path(qb, tb):
        """B2/B3's operands, boxes, visit lists and plain 1-NN."""
        t_aug = tnn.build_nn_target(tb, bt=512)
        boxes = tnn.chunk_boxes(tb, torch.ones(tb.shape[:-1], dtype=torch.bool), t_aug.shape[-2], bt=512)
        tiles = tnn.tile_boxes(qb)
        cnt, ids = tnn.visit_lists(*tiles, *boxes, 4.0)
        return t_aug, boxes, tiles, (cnt, ids), tnn.nn_visits_plain(cnt, ids, tnn.pack_query(qb), t_aug, 512)

    _assert_same(nn_path(q, t), _members(nn_path, q, t))

    def pruned(qb, tb, rb):
        """B1/B4's visit lists and plain moments, one radius per member."""
        cnt, ids = tmom.prune(qb, tb, rb)
        return (cnt, ids), tmom.moments_visits_plain(cnt, ids, rb.reshape(-1), *tmom.pack_operands(qb, tb))

    _assert_same(pruned(q, t, r2), _members(pruned, q, t, r2))

    def dense(qb, tb, rb):
        """B5/B6's plain moments."""
        qd, td = tmom.pack_operands(qb, tb, bt=tmom.DENSE_BT)
        return tmom.moments_dense_batched(rb, qd, td) if qb.dim() == 3 else tmom.moments_dense(rb.reshape(1), qd, td)

    _assert_same(dense(q, t, r2), _members(dense, q, t, r2))


def _tunnel_scans(leaves, capacity=1024):
    seqs = [make_tunnel_sequence(num_scans=1, azimuth_steps=256, step=0.3, seed=s) for s in range(len(leaves))]
    raw = [PointCloud.from_points(s.scans[0][s.scan_valid[0]], capacity=4096) for s in seqs]
    return PointCloud(*(torch.stack(x) for x in zip(*raw)))


def test_batched_voxel_normals_crop_equal_single_loop():
    """Per-member adaptive leaves: the voxel keys, the normals radius and
    the moment visit lists all differ by member."""
    leaves = to_torch(np.asarray([0.1, 0.17, 0.3], np.float32))
    raw = _tunnel_scans(leaves)
    from locus_tpu_torch.ops import filters

    def pre(pc, leaf):
        pc = filters.crop_box(pc, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
        pc = tvoxel.voxel_downsample(pc, leaf, capacity=1024, with_attributes=False)
        return tnorm.estimate_normals_radius(pc, radius=2.5 * leaf)

    _assert_same(pre(raw, leaves), _members(pre, raw, leaves))
    # with attributes, and a capacity that forces stride sampling
    pc = raw._replace(normals=torch.nn.functional.normalize(raw.xyz + 1.0, dim=-1))

    def down(c, leaf):
        return tvoxel.voxel_downsample(c, leaf, capacity=300)

    _assert_same(down(pc, leaves), _members(down, pc, leaves))


def _cube(step=0.1, capacity=1024, **kw):
    xyz, nrm = synthetic.hollow_cube(step=step, **kw)
    return PointCloud.from_points(xyz, capacity=capacity, normals=nrm)


def test_batched_gicp_equals_single_member_by_member():
    """Members that converge after different numbers of outer iterations,
    one that ends on the cap with the final re-lookup, and a warm start:
    each member's transform, iterations, fitness and correspondences equal
    its single call."""
    src = _cube()
    motions = [([0.0, 0.0, 0.0], [0.05, 0.0, 0.0]), ([0.0, 0.0, 0.04], [0.08, -0.05, 0.03]),
               ([0.0, 0.0, 0.3], [0.4, 0.1, 0.0]), ([0.0, 0.0, 0.3], [0.4, 0.1, 0.0]),
               ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])]
    Ts = [se3.make_transform(se3.so3_exp(torch.tensor(w)), torch.tensor(t)) for w, t in motions]
    warm = se3.make_transform(se3.so3_exp(torch.tensor([0.02, 0.02, 0.32])), torch.tensor([0.37, 0.07, -0.03]))
    guess = torch.stack([se3.identity(), se3.identity(), se3.identity(), warm, se3.identity()])
    srcs = stack_states([src] * len(Ts))
    tgts = stack_states([src.transform(T) for T in Ts])
    cfg = RegistrationConfig(iterations=3, final_correspondence_relookup=True)
    batched = gicp_register(srcs, tgts, guess, cfg)
    singles = [gicp_register(src, member(tgts, b), guess[b], cfg) for b in range(len(Ts))]
    its = [int(s.iterations) for s in singles]
    assert set(its) == {1, 2, 3} and not all(bool(s.converged) for s in singles), its
    for b, s in enumerate(singles):
        _assert_same(tuple(x[b] for x in batched), tuple(s))


def _grid(offset, n=64, capacity=128, seed=1):
    rng = np.random.default_rng(seed + int(offset * 100))
    pts = (rng.uniform(0, 5, size=(n, 3)) + offset).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    return PointCloud.from_points(pts, capacity=capacity, normals=nrm / np.linalg.norm(nrm, axis=1, keepdims=True))


def test_batched_map_equals_single_loop():
    """Inserts with per-member ring pointers (the members restart their
    rings at different inserts), per-member `enabled`, the ANN and the MSW
    refresh."""
    cfg = MapperConfig(map_capacity=384, keyframe_capacity=128, map_voxel_leaf=0.01, box_filter_size=12.0)
    singles = [tkm.init_map(cfg, device="cpu")] * 3
    state = stack_states(singles)
    flags = [(True, True, False), (True, False, True), (True, True, True), (False, True, True), (True, True, True)]
    for i, en in enumerate(flags):
        kfs = [_grid(4.0 * i + b, n=60 + 20 * b, seed=b) for b in range(3)]
        enabled = torch.tensor(en)
        state = tkm.insert_keyframe(state, stack_states(kfs), cfg, enabled=enabled)
        singles = [tkm.insert_keyframe(s, k, cfg, enabled=enabled[b]) for b, (s, k) in enumerate(zip(singles, kfs))]
        _assert_same(state, stack_states(singles))
        queries = [_grid(4.0 * i + 1.0, seed=7 + b) for b in range(3)]
        _assert_same(
            tkm.approx_nearest_neighbors(state, stack_states(queries), return_d2=True, radius=1.0),
            stack_states([tkm.approx_nearest_neighbors(s, qb, return_d2=True, radius=1.0)
                          for s, qb in zip(singles, queries)]),
        )
    assert len({int(p) for p in state.write_ptr}) == 3
    pos = torch.tensor([[6.0, 6.0, 6.0], [10.0, 10.0, 10.0], [14.0, 14.0, 14.0]])
    enabled = torch.tensor([True, False, True])
    state = tkm.refresh_msw(state, pos, cfg, enabled=enabled)
    singles = [tkm.refresh_msw(s, pos[b], cfg, enabled=enabled[b]) for b, s in enumerate(singles)]
    _assert_same(state, stack_states(singles))
    assert 0 < int(tkm.map_size(member(state, 0))) < int(tkm.map_size(member(state, 1)))
