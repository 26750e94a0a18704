"""The batched building blocks of the configurations beyond the default
(ROADMAP A15b), each against a loop of its single call, bit for bit
(`assert_array_equal`), as tests/test_torch_batched.py holds the default
path's: the per-member row scatters, k-NN and radius counts with near
ties, the NDT target build and registration (the per-member hash lookup,
the masked outer loop and the per-member Moré–Thuente search), the LOAM
feature extraction and the voxel-hash map's inserts."""
import numpy as np
import pytest
import torch

from locus_tpu_torch.config import MapperConfig, RegistrationConfig
from locus_tpu_torch.core.cloud import PointCloud, last_writes, put_rows, scatter_rows
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.io import synthetic
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.mapping import voxel_hash_map as vhm
from locus_tpu_torch.ops import features, filters, neighbors, normals
from locus_tpu_torch.pipeline import member, stack_states
from locus_tpu_torch.registration import ndt
from tests.torch_helpers import np_


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np_(a), np_(b))


def _members(fn, *batched):
    """fn on each member of the batched arguments, stacked."""
    outs = [fn(*(x[b] for x in batched)) for b in range(batched[0].shape[0])]
    if isinstance(outs[0], tuple):
        return stack_states(outs)
    return torch.stack(outs)


def test_row_scatters_per_member():
    """Duplicate writes within a member (the last wins), the same rows in
    every member (never shared), and rows outside the array (dropped)."""
    idx = torch.tensor([[3, 1, 3, 7, 9, 1, 0], [3, 3, 3, 2, -1, 5, 3], [0, 1, 2, 3, 4, 5, 6]])
    src = torch.arange(21, dtype=torch.float32).reshape(3, 7, 1).expand(3, 7, 2) * torch.tensor([1.0, -1.0])
    dst = torch.full((3, 6, 2), -5.0)
    _assert_same(last_writes(idx, 6), _members(lambda i: last_writes(i, 6), idx))
    _assert_same(scatter_rows(dst, idx, src), _members(scatter_rows, dst, idx, src))
    out = scatter_rows(dst, idx, src)
    assert out[1, 3].tolist() == [13.0, -13.0] and out[0, 3].tolist() == [2.0, -2.0]
    rows = torch.where(last_writes(idx, 6), idx, 6)
    _assert_same(put_rows(dst, rows, src), _members(put_rows, dst, rows, src))
    flags = torch.zeros((3, 6), dtype=torch.bool)
    _assert_same(put_rows(flags, rows, torch.ones((), dtype=torch.bool)),
                 _members(lambda f, r: put_rows(f, r, torch.ones((), dtype=torch.bool)), flags, rows))


def _lattice(seed, n=300):
    """Points on a 0.1 m lattice (exact ties of distance) with a few
    jittered by 1 ulp-scale offsets (near ties)."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-20, 20, size=(n, 3)).astype(np.float32) * 0.1
    pts[::7] += rng.normal(size=(len(pts[::7]), 3)).astype(np.float32) * 1e-6
    return torch.from_numpy(pts)


@pytest.mark.parametrize("chunk", [4096, 128])
def test_knn_and_radius_count_near_ties_per_member(chunk):
    q = torch.stack([_lattice(s) for s in range(3)])
    t = torch.stack([_lattice(10 + s, n=500) for s in range(3)])
    batched = neighbors.knn(q, t, k=9, chunk=chunk)
    _assert_same(batched, _members(lambda a, b: neighbors.knn(a, b, k=9, chunk=chunk), q, t))
    d2 = batched[0]
    assert bool((d2[..., 1:] == d2[..., :-1]).any())         # exact ties were there to break
    _assert_same(neighbors.radius_count(q, t, 0.25, chunk=chunk),
                 _members(lambda a, b: neighbors.radius_count(a, b, 0.25, chunk=chunk), q, t))
    _assert_same(neighbors.nearest(q, t, chunk=chunk), _members(lambda a, b: neighbors.nearest(a, b, chunk=chunk), q, t))


def _tunnel_clouds(capacity=2048, seeds=(0, 1, 2)):
    seqs = [make_tunnel_sequence(num_scans=1, azimuth_steps=256, step=0.3, seed=s) for s in seeds]
    return stack_states([PointCloud.from_points(s.scans[0][s.scan_valid[0]], capacity=capacity) for s in seqs])


def test_filters_and_knn_normals_per_member():
    pcs = _tunnel_clouds()
    for fn in (lambda c: filters.statistical_outlier(c, 8, 1.0), lambda c: filters.radius_outlier(c, 0.4, 3),
               lambda c: filters.passthrough(c, "z", -0.5, 1.5), lambda c: normals.estimate_normals(c, k=12)):
        _assert_same(fn(pcs), stack_states([fn(member(pcs, b)) for b in range(3)]))
    gens = [torch.Generator().manual_seed(s) for s in (5, 6, 7)]
    pct = torch.tensor([0.5, 0.9, 0.1])
    batched = filters.random_sample(pcs, gens, pct)
    singles = [filters.random_sample(member(pcs, b), torch.Generator().manual_seed(5 + b), pct[b]) for b in range(3)]
    _assert_same(batched, stack_states(singles))


def test_ndt_targets_and_registration_per_member():
    """The per-member sorts, segment sums and hash tables; then NDT in both
    optimisers on members that stop after different numbers of outer
    iterations (one at its cap), each member equal to its single call."""
    src = PointCloud.from_points(synthetic.hollow_cube(step=0.1)[0], capacity=1024)
    motions = [([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]), ([0.0, 0.0, 0.05], [0.1, -0.05, 0.02]),
               ([0.02, 0.0, 0.2], [0.3, 0.1, 0.0])]
    Ts = [se3.make_transform(se3.so3_exp(torch.tensor(w)), torch.tensor(t)) for w, t in motions]
    srcs = stack_states([src] * 3)
    tgts = stack_states([src.transform(T) for T in Ts])
    _assert_same(ndt.build_ndt_targets(tgts, 0.5), stack_states([ndt.build_ndt_targets(member(tgts, b), 0.5)
                                                                  for b in range(3)]))
    for optimizer, iters in (("irls", 6), ("newton", 12)):
        cfg = RegistrationConfig(registration_method="ndt", ndt_resolution=0.5, ndt_optimizer=optimizer,
                                 iterations=iters, ndt_newton_warmstart=2)
        batched = ndt.ndt_register(srcs, tgts, cfg=cfg)
        singles = [ndt.ndt_register(src, member(tgts, b), cfg=cfg) for b in range(3)]
        its = [int(s.iterations) for s in singles]
        assert len(set(its)) > 1, (optimizer, its)
        for b, s in enumerate(singles):
            _assert_same(tuple(x[b] for x in batched), tuple(s))


def test_more_thuente_per_member():
    """phi(a) = c/2 (a - s)^2 + w a^4 per member: member 0 starts at its
    minimum (no trial), the others overshoot far and need several trials;
    each member's step equals its single search's, with the trial count
    of that search."""
    c = torch.tensor([2.0, 10.0, 8.4])
    s = torch.tensor([0.3, 0.003, 0.0026])
    w = torch.tensor([0.0, 800.0, 160.0])
    init = torch.tensor([0.3, 0.94, 0.94])
    lo, hi = torch.tensor(5e-4), torch.tensor(1.0)
    calls = []

    def phi_of(c_, s_, w_):
        def phi(a):
            calls.append(a.shape)
            return 0.5 * c_ * (a - s_) ** 2 + w_ * a ** 4, c_ * (a - s_) + 4.0 * w_ * a ** 3
        return phi

    phi0, dphi0 = 0.5 * c * s * s, -c * s
    batched = ndt._more_thuente_alpha(phi_of(c, s, w), phi0, dphi0, init, lo, hi)
    trials = []
    for b in range(3):
        calls.clear()
        single = ndt._more_thuente_alpha(phi_of(c[b], s[b], w[b]), phi0[b], dphi0[b], init[b], lo, hi)
        trials.append(len(calls) - 1)
        np.testing.assert_array_equal(np_(batched[b]), np_(single))
    assert trials[0] == 0 and min(trials[1:]) >= 2, trials


def test_features_per_member():
    pcs = _tunnel_clouds(capacity=4096)
    batched = features.extract_features(pcs, width=256)
    _assert_same(batched, stack_states([features.extract_features(member(pcs, b), width=256) for b in range(3)]))
    assert int((batched.label > 0).sum()) > 0
    clouds = features.feature_clouds(batched, 128, 900, source=pcs)
    singles = [features.feature_clouds(features.FeatureGrid(*(x[b] for x in batched)), 128, 900,
                                       source=member(pcs, b)) for b in range(3)]
    _assert_same(clouds, tuple(stack_states([s[i] for s in singles]) for i in range(2)))


def test_voxel_hash_inserts_per_member():
    """Inserts whose slots collide within a member and across members, with
    per-member `enabled`; the map's ANN, MSW refresh and size."""
    cfg = MapperConfig(map_capacity=512, keyframe_capacity=256, map_voxel_leaf=0.2, box_filter_size=10.0,
                       structure="voxel_hash")
    singles = [vhm.init_map(cfg, device="cpu")] * 3
    state = stack_states(singles)
    rng = np.random.default_rng(0)
    flags = [(True, True, False), (True, False, True), (False, True, True), (True, True, True)]
    for i, en in enumerate(flags):
        kfs = [PointCloud.from_points((rng.uniform(-3, 3, size=(150 + 30 * b, 3)) + i).astype(np.float32),
                                      capacity=256) for b in range(3)]
        enabled = torch.tensor(en)
        state = vhm.insert_keyframe(state, stack_states(kfs), cfg, enabled=enabled)
        singles = [vhm.insert_keyframe(s, k, cfg, enabled=enabled[b]) for b, (s, k) in enumerate(zip(singles, kfs))]
        _assert_same(state, stack_states(singles))
        queries = stack_states([PointCloud.from_points(rng.uniform(-2, 4, size=(100, 3)).astype(np.float32),
                                                       capacity=128) for _ in range(3)])
        _assert_same(vhm.approx_nearest_neighbors(state, queries, return_d2=True, radius=1.0),
                     stack_states([vhm.approx_nearest_neighbors(s, member(queries, b), return_d2=True, radius=1.0)
                                   for b, s in enumerate(singles)]))
    sizes = vhm.map_size(state)
    assert len(set(sizes.tolist())) == 3 and int(sizes.min()) > 0
    pos = torch.tensor([[0.0, 0.0, 0.0], [3.0, 3.0, 3.0], [1.0, 1.0, 1.0]])
    enabled = torch.tensor([True, False, True])
    state = vhm.refresh_msw(state, pos, cfg, enabled=enabled)
    singles = [vhm.refresh_msw(s, pos[b], cfg, enabled=enabled[b]) for b, s in enumerate(singles)]
    _assert_same(state, stack_states(singles))
