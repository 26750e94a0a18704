"""Kernel B1 (box-pruned radius moments) and the radius normals against
the JAX package.

The plain PyTorch version runs here; the JAX side runs its Pallas kernel
in interpret mode and its XLA path. Tolerances:
- counts exact, except for queries with a neighbour whose float64
  distance lies within 1e-5 r of r (both sides gate on a rounded
  expanded form; the test computes which queries those are);
- raw sums rtol 1e-5, with an absolute floor of 1e-6 of the largest term
  of the column so that sums which cancel to ~0 compare at f32 rounding;
- normals (of queries off the boundary) up to sign within
  1e-4 + 3 noise/gap, where gap is the float64
  gap between the two smallest eigenvalues of the point's neighbourhood
  and noise = 2.4e-7 |mean|^2 (two f32 ulps of the second moment) the
  rounding of a one-pass covariance entry: first-order perturbation theory moves the eigenvector by about
  noise/gap, so thin or line-like neighbourhoods, whose normal f32 cannot
  resolve, get the slack they need and well-conditioned ones are held
  to 1e-4.
The CUDA kernel itself is held against the plain version in
test_torch_gpu.py."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.ops import normals as jnorm, voxel as jvoxel
from locus_tpu.ops.dispatch import force_pallas
from locus_tpu.ops.pallas import moments as jmom
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.ops import normals as tnorm
from locus_tpu_torch.ops.kernels import moments as tmom
from tests.torch_helpers import np_, to_torch, torch_cloud

LEAVES = [0.1, 0.2, 0.4]


def _scan(leaf, capacity=2048, seed=3):
    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=512, step=0.3, seed=seed)
    xyz = seq.scans[0][seq.scan_valid[0]].astype(np.float32)
    pc = JPC.from_points(jnp.asarray(xyz), capacity=8192)
    return jvoxel.voxel_downsample(pc, jnp.float32(leaf), capacity=capacity, with_attributes=False)


def _exact_neighbourhoods(xyz, mask, r):
    """float64 pairwise distances of the valid points: (d (n,n), boundary
    (n,) — a neighbour within 1e-5 r of the radius)."""
    X = xyz.astype(np.float64)
    d = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    d[:, ~mask] = np.inf
    boundary = np.any(np.abs(d - r) <= 1e-5 * r, axis=1)
    return d, boundary


def _raw_sums(count, mean, cov):
    """(n, 10) raw moment sums rebuilt in float64 from component form."""
    n = np.asarray(count, np.float64)
    m = [np.asarray(c, np.float64) for c in mean]
    c = [np.asarray(v, np.float64) for v in cov]
    cxx, cxy, cxz, cyy, cyz, czz = c
    second = [cxx + m[0] * m[0], cyy + m[1] * m[1], czz + m[2] * m[2],
              cxy + m[0] * m[1], cxz + m[0] * m[2], cyz + m[1] * m[2]]
    return np.stack([n * v for v in m] + [n * v for v in second] + [n], axis=1)


@pytest.mark.parametrize("leaf", LEAVES)
def test_moments_plain_matches_pallas_and_xla(leaf):
    pc = _scan(leaf)
    r = np.float32(2.5 * leaf)
    xyz, mask = np_(pc.xyz), np_(pc.mask)
    t = tmom.radius_moments_pruned_comps(to_torch(xyz), to_torch(xyz), to_torch(r))
    jp = jmom.radius_moments_pallas_pruned_comps(pc.xyz, pc.xyz, r, interpret=True)
    jx = jmom.radius_moments_xla_comps(pc.xyz, pc.xyz, pc.mask, r)
    _, boundary = _exact_neighbourhoods(xyz, mask, float(r))
    ts = _raw_sums(np_(t[0]), [np_(v) for v in t[1]], [np_(v) for v in t[2]])
    for j in (jp, jx):
        js = _raw_sums(np_(j[0]), [np_(v) for v in j[1]], [np_(v) for v in j[2]])
        same = mask & ~boundary
        np.testing.assert_array_equal(ts[same, 9], js[same, 9])
        scale = np.abs(js[same]).max(axis=0)
        err = np.abs(ts[same] - js[same])
        assert np.all(err <= 1e-5 * np.abs(js[same]) + 1e-6 * scale), err.max(axis=0)


@pytest.mark.parametrize("leaf", LEAVES)
def test_pruning_is_exact(leaf):
    """The visit lists skip only chunks that cannot hold a neighbour: the
    pruned sums equal those of a run that visits every chunk (f32
    features summed in float64 do not depend on the order)."""
    pc = _scan(leaf)
    xyz = to_torch(pc.xyz)
    r2 = torch.tensor((2.5 * leaf) ** 2, dtype=torch.float32).reshape(1)
    cnt, ids = tmom.prune(xyz, xyz, r2)
    q, t = tmom.pack_operands(xyz, xyz)
    pruned = tmom.moments_visits(cnt, ids, r2, q, t)
    num_chunks = t.shape[0] // tmom.MBT
    all_cnt = torch.full_like(cnt, num_chunks)
    all_ids = torch.arange(num_chunks, dtype=torch.int32).repeat(cnt.shape[0])
    full = tmom.moments_visits(all_cnt, all_ids, r2, q, t)
    valid = torch.all(q[:, :3].abs() < 1e7, dim=1) & (q[:, 3] > 0)
    np.testing.assert_array_equal(np_(pruned[valid]), np_(full[valid]))
    assert np_(cnt).sum() < 0.7 * cnt.shape[0] * num_chunks


@pytest.mark.parametrize("leaf", LEAVES)
def test_estimate_normals_radius_matches(leaf):
    pc = _scan(leaf)
    r = np.float32(2.5 * leaf)
    t = tnorm.estimate_normals_radius(torch_cloud(pc), to_torch(r))
    with force_pallas():
        jp = jnorm.estimate_normals_radius(pc, r)
    jx = jnorm.estimate_normals_radius(pc, r)
    xyz, mask = np_(pc.xyz), np_(pc.mask)
    d, boundary = _exact_neighbourhoods(xyz, mask, float(r))
    X = xyz.astype(np.float64)
    bound = np.full(len(X), np.inf)
    for i in np.nonzero(mask)[0]:
        P = X[d[i] <= r]
        if len(P) < 4:
            continue
        w = np.linalg.eigvalsh(np.cov(P.T, bias=True))
        noise = 2.4e-7 * float((P.mean(0) ** 2).sum())
        bound[i] = 1e-4 + 3.0 * noise / max(w[1] - w[0], 1e-300)
    tn = np_(t.normals)
    for j in (jp, jx):
        jn = np_(j.normals)
        np.testing.assert_array_equal(np.any(tn != 0, 1), np.any(jn != 0, 1))
        diff = np.minimum(np.abs(tn - jn).max(1), np.abs(tn + jn).max(1))
        held = mask & ~boundary & np.isfinite(bound)
        assert held.sum() > 0.5 * mask.sum()
        assert np.all(diff[held] <= bound[held]), np.max(diff[held] - bound[held])
        # most normals are well conditioned and agree to 1e-4
        assert np.mean(diff[held] <= 1e-4) > 0.7, np.mean(diff[held] <= 1e-4)


def test_eigen_solvers_match(rng):
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + np.diag([0.0, 1.0, 3.0]).astype(np.float32)
    jl, jv = jnorm.smallest_eigenvector_sym3x3(jnp.asarray(A))
    tl, tv = tnorm.smallest_eigenvector_sym3x3(to_torch(A))
    np.testing.assert_allclose(np_(tl), np_(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.abs(np.sum(np_(tv) * np_(jv), -1)), 1.0, atol=1e-4)
    jw, jV = jnorm.eigh_sym3x3(jnp.asarray(A))
    tw, tV = tnorm.eigh_sym3x3(to_torch(A))
    np.testing.assert_allclose(np_(tw), np_(jw), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.abs(np.sum(np_(tV) * np_(jV), -2)), 1.0, atol=1e-3)


def _visit_case(rng, batch, every_chunk, num_tiles=6, num_chunks=4, r=0.6, bt=tmom.MBT):
    """Packed operands and visit lists of kernel B1 (batch 0) or B4 at
    chunk `bt` (MBT = 512; B5/B6 take DENSE_BT and every chunk): points
    straddling 0 on every axis, a thin (1e-4 m thick) sheet and a line in
    the first two chunks (thin neighbourhoods), the queries a jittered
    subset of the targets, padding rows at the end. Tile 1 visits nothing;
    with `every_chunk` the others visit every chunk, else a random subset
    in ascending order."""
    nb = max(batch, 1)
    m = num_chunks * bt - 100
    pts = rng.uniform(-2.0, 2.0, size=(nb, m, 3)).astype(np.float32)
    pts[:, :300, 2] = rng.normal(scale=1e-4, size=(nb, 300))                   # sheet
    pts[:, 300:600] = np.linspace(-1, 1, 300)[:, None] * np.float32([1.0, 0.5, -0.25])  # line
    qry = pts[:, rng.choice(m, num_tiles * tmom.BQ - 30, replace=False)]
    qry = qry + rng.normal(scale=0.05, size=qry.shape).astype(np.float32)
    lead = (batch,) if batch else ()
    to_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).reshape(lead + x.shape[1:])
    q, t = tmom.pack_operands(to_t(qry), to_t(pts), bt=bt)
    visit = np.ones((nb, num_tiles, num_chunks), bool) if every_chunk else rng.uniform(size=(nb, num_tiles, num_chunks)) < 0.6
    visit[:, 1] = False
    cnt = visit.sum(-1).astype(np.int32)
    ids = np.zeros((nb, num_tiles, num_chunks), np.int32)
    for b, g in np.ndindex(nb, num_tiles):
        ids[b, g, : cnt[b, g]] = np.nonzero(visit[b, g])[0]
    r2 = torch.full((nb,), r * r, dtype=torch.float32)
    return to_t(cnt), to_t(ids.reshape(nb, -1)), r2, q, t


def _fixed_order_sums(cnt, ids, r2, q, t):
    """B1/B4's order of summation, in float64: per member and query, the
    partial of each QUARTER of the chunks (targets 128w .. 128w + 127 of
    every visited chunk, in list order), then ((P0 + P1) + (P2 + P3)), then
    one f32 rounding."""
    lead = q.shape[:-2]
    cnt, ids, q, t = (x.reshape((-1,) + x.shape[len(lead):]) for x in (cnt, ids, q, t))
    r2 = r2.reshape(-1)
    out = torch.empty(q.shape[:-1] + (tmom.NM,), dtype=torch.float32)
    num_chunks = t.shape[-2] // tmom.MBT
    for b in range(q.shape[0]):
        x, y, z = t[b, :, 0], t[b, :, 1], t[b, :, 2]
        feat = torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z, torch.ones_like(x)], -1).double()
        score = t[b, None, :, 3] + q[b, :, 0:1] * (-2.0 * t[b, None, :, 0]) + q[b, :, 1:2] * (-2.0 * t[b, None, :, 1]) \
            + q[b, :, 2:3] * (-2.0 * t[b, None, :, 2])
        W = ((score + q[b, :, 3:4]) <= r2[b]).double()
        for g in range(cnt.shape[-1]):
            rows = slice(g * tmom.BQ, (g + 1) * tmom.BQ)
            part = torch.zeros((4, tmom.BQ, tmom.NM), dtype=torch.float64)
            for v in range(int(cnt[b, g])):
                c = int(ids[b, g * num_chunks + v])
                for w in range(4):
                    cols = slice(c * tmom.MBT + w * tmom.QUARTER, c * tmom.MBT + (w + 1) * tmom.QUARTER)
                    part[w] += W[rows, cols] @ feat[cols]
            out[b, rows] = ((part[0] + part[1]) + (part[2] + part[3])).float()
    return out.reshape(lead + out.shape[1:])


@pytest.mark.parametrize("every_chunk", [False, True], ids=["visit_lists", "every_chunk"])
@pytest.mark.parametrize("batch", [0, 3], ids=["single", "batched"])
def test_moments_visits_fixed_partials_are_bit_exact(rng, batch, every_chunk):
    """The premise of the B1/B4 kernel's split: its fixed partials (one per
    quarter of the visited chunks, in list order) combined in its fixed
    order give the plain version's bits on every row, tiles with no visits
    and thin neighbourhoods included; a batch member gets the bits of its
    single call."""
    cnt, ids, r2, q, t = _visit_case(rng, batch, every_chunk)
    plain = tmom.moments_visits_plain(cnt, ids, r2, q, t)
    np.testing.assert_array_equal(np_(_fixed_order_sums(cnt, ids, r2, q, t)), np_(plain))
    assert not plain[..., tmom.BQ : 2 * tmom.BQ, :].any()  # tile 1 visits nothing
    assert float(plain[..., 9].mean()) > 5  # the radius holds real neighbourhoods
    for b in range(batch):
        single = tmom.moments_visits_plain(cnt[b], ids[b], r2[b:b + 1], q[b], t[b])
        np.testing.assert_array_equal(np_(plain[b]), np_(single))


def _dense_fixed_order_sums(r2, q, t):
    """B5/B6's order of summation, in float64: per member, tile and split
    j of S = DENSE_SPLIT[0], whose quads (4 consecutive targets) are j,
    j + S, j + 2S, ... of the targets (quad u of that list to column u mod
    4), a partial per column over its quads in order, the block's
    ((Q0 + Q1) + (Q2 + Q3)), then the splits' partials added in split
    order, then one f32 rounding."""
    lead = q.shape[:-2]
    q, t = (x.reshape((-1,) + x.shape[len(lead):]) for x in (q, t))
    r2 = r2.reshape(-1)
    splits = tmom.DENSE_SPLIT[0]
    num_quads = t.shape[-2] // 4
    out = torch.empty(q.shape[:-1] + (tmom.NM,), dtype=torch.float32)
    for b in range(q.shape[0]):
        x, y, z = t[b, :, 0], t[b, :, 1], t[b, :, 2]
        feat = torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z, torch.ones_like(x)], -1).double()
        score = t[b, None, :, 3] + q[b, :, 0:1] * (-2.0 * t[b, None, :, 0]) + q[b, :, 1:2] * (-2.0 * t[b, None, :, 1]) \
            + q[b, :, 2:3] * (-2.0 * t[b, None, :, 2])
        W = ((score + q[b, :, 3:4]) <= r2[b]).double()
        for g in range(q.shape[1] // tmom.BQ):
            rows = slice(g * tmom.BQ, (g + 1) * tmom.BQ)
            total = None
            for j in range(splits):
                part = torch.zeros((4, tmom.BQ, tmom.NM), dtype=torch.float64)
                for u, quad in enumerate(range(j, num_quads, splits)):
                    cols = slice(4 * quad, 4 * quad + 4)
                    part[u % 4] += W[rows, cols] @ feat[cols]
                block = (part[0] + part[1]) + (part[2] + part[3])
                total = block if total is None else total + block
            out[b, rows] = total.float()
    return out.reshape(lead + out.shape[1:])


@pytest.mark.parametrize("num_chunks", [1, 5], ids=["one_chunk", "five_chunks"])
@pytest.mark.parametrize("batch", [0, 3], ids=["single", "batched"])
def test_moments_dense_fixed_partials_are_bit_exact(rng, batch, num_chunks):
    """The premise of the B5/B6 kernel's split: its fixed partials (per
    column of each split's interleaved quads, then per split, merged in
    split order) give the plain version's bits on every row, thin
    neighbourhoods included, at one 1024-point chunk (32 quads a split: part
    of a slice) and five (160: a full slice and part of another); a batch
    member gets the bits of its single call."""
    _, _, r2, q, t = _visit_case(rng, batch, True, num_tiles=3, num_chunks=num_chunks, bt=tmom.DENSE_BT)
    run = tmom.moments_dense_batched if batch else tmom.moments_dense
    plain = run(r2, q, t)
    np.testing.assert_array_equal(np_(_dense_fixed_order_sums(r2, q, t)), np_(plain))
    assert float(plain[..., 9].mean()) > 5  # the radius holds real neighbourhoods
    for b in range(batch):
        np.testing.assert_array_equal(np_(plain[b]), np_(tmom.moments_dense(r2[b:b + 1], q[b], t[b])))


def _apart(lo, hi, q2, glo, ghi, g2, r2):
    """The B1/B4 kernel's skip test (`apart` in csrc/moments.cu), in f32."""
    f32 = np.float32
    gap = np.maximum(np.maximum(glo - hi, lo - ghi), f32(0))
    gap2 = (gap * gap).sum(-1, dtype=np.float32)
    return gap2 * f32(1 - 2.0 ** -20) > f32(r2) + f32(2.0 ** -19) * (q2 + g2)


@pytest.mark.parametrize("scale,spread", [(1.0, 2e-5), (40.0, 2e-3)], ids=["near", "far"])
def test_moments_visits_group_pruning_keeps_every_neighbour(rng, scale, spread):
    """The kernel skips a (query octet, 32-target group) pair when their
    boxes lie farther apart than the radius plus a margin for the f32
    gate's rounding. Mirrored here where that margin is all that keeps a
    neighbour: each octet is 8 copies of a point and the group beside it
    32 targets at the radius times 1 +- `spread` (a few rounding units of
    the gate at 1 m and 40 m from the origin; every other group wholly
    beyond the radius), with sentinel rows. Every pair the plain version's
    gate passes, those beyond the radius included, lies in a pair of boxes
    the test keeps, and most pairs are skipped."""
    r = np.float32(0.3)
    base = rng.uniform(-1, 1, size=(64, 3)) * scale
    base = base[np.argsort(base[:, 0])]
    dirs = rng.normal(size=(64, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    eps = rng.uniform(-spread, spread, size=(64, 32, 1))
    eps[::2] = np.abs(eps[::2])  # every other group lies wholly beyond the radius
    qry = np.repeat(base, 8, axis=0).astype(np.float32)
    tgt = (base[:, None] + dirs[:, None] * float(r) * (1 + eps)).reshape(-1, 3).astype(np.float32)
    qry[-5:] = tgt[-7:] = 1e8  # sentinel rows pass the gate against each other
    q, t = tmom.pack_operands(torch.from_numpy(qry), torch.from_numpy(tgt))
    q, t = np_(q), np_(t)
    r2 = np.float32(r * r)
    score = t[None, :, 3] + q[:, None, 0] * (-2 * t[None, :, 0]) + q[:, None, 1] * (-2 * t[None, :, 1]) \
        + q[:, None, 2] * (-2 * t[None, :, 2])
    passes = (score + q[:, None, 3]) <= r2
    d = np.linalg.norm(q[:, None, :3].astype(np.float64) - t[None, :, :3], axis=-1)
    assert (passes & (d > r)).any() and (~passes & (d < 1.1 * r)).any()  # the boundary is in play
    real = t[:, 3] != np.float32(tmom.PAD_T2)
    tg, rg, qo = t.reshape(-1, 32, 4), real.reshape(-1, 32, 1), q.reshape(-1, 8, 4)
    glo = np.where(rg, tg[..., :3], np.inf).min(1)
    ghi = np.where(rg, tg[..., :3], -np.inf).max(1)
    g2 = np.where(rg[..., 0], tg[..., 3], 0).max(1)
    skip = _apart(qo[:, None, :, :3].min(2), qo[:, None, :, :3].max(2), qo[:, None, :, 3].max(2),
                  glo[None], ghi[None], g2[None], r2)
    assert not (passes & skip.repeat(8, 0).repeat(32, 1)).any()
    assert skip.mean() > 0.5, skip.mean()


def test_moments_splits_from_the_shapes():
    """B1/B4 and B5/B6 each launch one instance, fixed in csrc/moments.cu:
    their grids depend on the shapes only (no visit count read), and the
    batched kernels at any batch give each member the blocks (and so the
    partial structure) of the single ones. B5 at B1's 64 tiles launches at
    least two blocks for each of the H100's 132 SMs."""
    src = (Path(tmom.__file__).resolve().parents[2] / "csrc" / "moments.cu").read_text()
    qs, warps = tmom.SPLIT
    splits, octets = tmom.DENSE_SPLIT
    assert f"constexpr int QUERY_SPLITS = {qs}, WARPS = {warps};" in src
    assert f"constexpr int DENSE_SPLITS = {splits}, DENSE_OCTETS = {octets};" in src
    for batch, tiles in ((1, 64), (4, 64), (16, 64), (1, 16), (4, 256)):
        assert tmom.launch_grid("visits", batch, tiles) == ((tiles * qs, batch, 1), 128 * warps)
        assert tmom.launch_grid("dense", batch, tiles) == ((tiles, batch, splits), 1024 // octets)
    assert (tmom.BQ // qs) % (8 * warps) == 0  # whole octets of queries a warp
    assert 8 % octets == 0  # a tile's 8 octets split evenly over the warps of a column
    assert tmom.DENSE_BT % tmom.MBT == 0  # whole slices a chunk
    (gx, gy, gz), _ = tmom.launch_grid("dense", 1, 64)
    assert gx * gy * gz >= 2 * 132


def test_moments_visits_uses_plain_on_cpu(rng):
    cnt, ids, r2, q, t = _visit_case(rng, 0, False)
    before = (tmom.launches, tmom.batched_launches)
    out = tmom.moments_visits(cnt, ids, r2, q, t)
    np.testing.assert_array_equal(np_(out), np_(tmom.moments_visits_plain(cnt, ids, r2, q, t)))
    cnt, ids, r2, q, t = _visit_case(rng, 2, False)
    out = tmom.moments_visits_batched(cnt, ids, r2, q, t)
    np.testing.assert_array_equal(np_(out), np_(tmom.moments_visits_plain(cnt, ids, r2, q, t)))
    assert (tmom.launches, tmom.batched_launches) == before
