"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the same inputs, and the pipeline's entry points on the card.

Every test here takes the `cuda_device` fixture and skips without a card.
This file imports neither JAX nor `locus_tpu`, so it also runs on a
machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: exact. The kernels round their scores and gates in the same
steps as their plain versions, and the moments kernels sum their f32
features in float64, where the order of summation does not matter. The
batched kernels (B3, B4, B6) give each member the bits of its single
launch, and the batched replay each robot the poses of its single replay.
"""
import numpy as np
import pytest
import torch

from locus_tpu_torch import config as cfg_mod, pipeline, runner
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.ops import dispatch, voxel
from locus_tpu_torch.ops.kernels import moments as tmom, nn as tnn

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none. Decided here,
    at run time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def np_(x):
    return x.detach().cpu().numpy()


def _cloud(device, capacity, leaf, seed, shift=(0.0, 0.0, 0.0)):
    """A voxelised tunnel scan in sorted-voxel order, sentinel-padded."""
    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=900, step=0.3, seed=seed)
    xyz = seq.scans[0][seq.scan_valid[0]].astype(np.float32) + np.float32(shift)
    pc = PointCloud.from_points(xyz, capacity=max(capacity, xyz.shape[0]), device=device)
    pc = voxel.voxel_downsample(pc, leaf, capacity=capacity, with_attributes=False)
    return pc.xyz, pc.mask


@pytest.mark.parametrize("bt,m,radius", [(512, 4096, 1.0), (2048, 16384, 2.0)])
def test_nn_kernel_matches_plain(cuda_device, bt, m, radius):
    q, _ = _cloud(cuda_device, 4096, 0.1, 8, shift=(0.1, -0.05, 0.02))
    t, tm = _cloud(cuda_device, m, 0.05, 9)
    t_aug = tnn.build_nn_target(t, bt=bt)
    cmin, cmax = tnn.chunk_boxes(t, tm, t_aug.shape[0], bt=bt)
    tmin, tmax = tnn.tile_boxes(q)
    cnt, ids = tnn.visit_lists(tmin, tmax, cmin, cmax, radius * radius)
    qp = tnn.pack_query(q)
    before = tnn.launches[bt]
    kd, ki = tnn.nn_visits(cnt, ids, qp, t_aug, bt)
    torch.cuda.synchronize()
    assert tnn.launches[bt] == before + 1
    with dispatch.no_kernels():
        pd, pi = tnn.nn_visits(cnt, ids, qp, t_aug, bt)
    assert tnn.launches[bt] == before + 1
    np.testing.assert_array_equal(np_(kd), np_(pd))
    np.testing.assert_array_equal(np_(ki), np_(pi))


@pytest.mark.parametrize("leaf", [0.1, 0.2, 0.4])
def test_moments_kernel_matches_plain(cuda_device, leaf):
    xyz, _ = _cloud(cuda_device, 4096, leaf, 3)
    r2 = torch.tensor((2.5 * leaf) ** 2, dtype=torch.float32, device=cuda_device).reshape(1)
    cnt, ids = tmom.prune(xyz, xyz, r2)
    q, t = tmom.pack_operands(xyz, xyz)
    before = tmom.launches
    k = tmom.moments_visits(cnt, ids, r2, q, t)
    torch.cuda.synchronize()
    assert tmom.launches == before + 1
    with dispatch.no_kernels():
        p = tmom.moments_visits(cnt, ids, r2, q, t)
    valid = np_(torch.all(q[:, :3].abs() < 1e7, dim=1) & (q[:, 3] > 0))
    np.testing.assert_array_equal(np_(k)[valid], np_(p)[valid])


def _batch(device, leaves, capacity=4096, seeds=(3, 4, 5, 6)):
    """B voxelised tunnel scans, one leaf each, stacked (B, capacity)."""
    clouds = [_cloud(device, capacity, leaf, seed) for leaf, seed in zip(leaves, seeds)]
    return torch.stack([c[0] for c in clouds]), torch.stack([c[1] for c in clouds])


@pytest.mark.parametrize("bt,m,radius", [(512, 4096, 1.0), (2048, 16384, 2.0)])
def test_batched_nn_kernel_matches_plain_and_single(cuda_device, bt, m, radius):
    """Kernel B3 on 4 members: equal to its plain version and, member by
    member, to kernel B2."""
    q, _ = _batch(cuda_device, [0.1, 0.12, 0.14, 0.16], seeds=(8, 10, 12, 14))
    t, tm = _batch(cuda_device, [0.05, 0.06, 0.07, 0.08], capacity=m, seeds=(9, 11, 13, 15))
    t_aug = tnn.build_nn_target(t, bt=bt)
    cmin, cmax = tnn.chunk_boxes(t, tm, t_aug.shape[-2], bt=bt)
    tmin, tmax = tnn.tile_boxes(q)
    cnt, ids = tnn.visit_lists(tmin, tmax, cmin, cmax, radius * radius)
    qp = tnn.pack_query(q)
    before = tnn.batched_launches[bt]
    kd, ki = tnn.nn_visits_batched(cnt, ids, qp, t_aug, bt)
    torch.cuda.synchronize()
    assert tnn.batched_launches[bt] == before + 1
    with dispatch.no_kernels():
        pd, pi = tnn.nn_visits_batched(cnt, ids, qp, t_aug, bt)
    np.testing.assert_array_equal(np_(kd), np_(pd))
    np.testing.assert_array_equal(np_(ki), np_(pi))
    for b in range(q.shape[0]):
        sd, si = tnn.nn_visits(cnt[b].contiguous(), ids[b].contiguous(), qp[b].contiguous(), t_aug[b].contiguous(), bt)
        np.testing.assert_array_equal(np_(kd[b]), np_(sd))
        np.testing.assert_array_equal(np_(ki[b]), np_(si))


def _nn_inputs(device, bt, batch, radius, seed=20, dup=False):
    """Visit lists and operands of kernel B2 (batch 0: no batch dimension)
    or B3 on voxelised tunnel scans: queries at leaf 0.1, targets at 0.05
    (4096 at bt 512, 16384 at 2048). With `dup`, the target cloud is its
    first half twice, so every target has an exact twin in another chunk."""
    m = 4096 if bt == 512 else 16384
    nb = max(batch, 1)
    q = torch.stack([_cloud(device, 4096, 0.1, seed + 2 * b, shift=(0.1, -0.05, 0.02))[0] for b in range(nb)])
    clouds = [_cloud(device, m, 0.05, seed + 2 * b + 1) for b in range(nb)]
    t, tm = torch.stack([c[0] for c in clouds]), torch.stack([c[1] for c in clouds])
    if dup:
        t, tm = t[:, : m // 2].repeat(1, 2, 1), tm[:, : m // 2].repeat(1, 2)
    if not batch:
        q, t, tm = q[0], t[0], tm[0]
    t_aug = tnn.build_nn_target(t, bt=bt)
    cmin, cmax = tnn.chunk_boxes(t, tm, t_aug.shape[-2], bt=bt)
    tmin, tmax = tnn.tile_boxes(q)
    cnt, ids = tnn.visit_lists(tmin, tmax, cmin, cmax, radius * radius)
    return cnt, ids, tnn.pack_query(q), t_aug


def _nn_kernel_and_plain(cnt, ids, q, t_aug, bt):
    """Kernel B2 or B3 (one launch, counted) and the plain version on the
    same inputs, as numpy (score bits, index) pairs."""
    batched = q.dim() == 3
    run, counts = (tnn.nn_visits_batched, tnn.batched_launches) if batched else (tnn.nn_visits, tnn.launches)
    before = counts[bt]
    kd, ki = run(cnt, ids, q, t_aug, bt)
    torch.cuda.synchronize()
    assert counts[bt] == before + 1
    with dispatch.no_kernels():
        pd, pi = run(cnt, ids, q, t_aug, bt)
    return (np_(kd.view(torch.int32)), np_(ki)), (np_(pd.view(torch.int32)), np_(pi))


def _assert_same_bits(a, b):
    np.testing.assert_array_equal(a[0], b[0])  # score bits
    np.testing.assert_array_equal(a[1], b[1])  # index


@pytest.mark.parametrize("batch", [0, 4, 16])
@pytest.mark.parametrize("bt,radius", [(512, 1.0), (2048, 2.0)])
def test_nn_kernel_split_matches_plain_bits(cuda_device, bt, radius, batch):
    """B2 (batch 0) and B3 at B = 4 and 16, on the grid the wrapper picks
    (a tile split by queries, by slices merged in the launch, or not):
    the plain version's score bits and indices."""
    cnt, ids, q, t_aug = _nn_inputs(cuda_device, bt, batch, radius)
    assert int(cnt.max()) * bt // tnn.SUB > 1
    _assert_same_bits(*_nn_kernel_and_plain(cnt, ids, q, t_aug, bt))


@pytest.mark.parametrize("query_splits", [1, 2, 4])
@pytest.mark.parametrize("target_splits", [1, 3, 8])
def test_nn_kernel_every_instance_matches_plain_bits(cuda_device, query_splits, target_splits):
    """Every instance of the kernel (64, 32 or 16 queries a block) at
    several target splits, forced, on B3 map-sized chunks with ties across
    slices (every target has a twin in another chunk, every chunk
    visited): the plain version's bits."""
    cnt, ids, q, t_aug = _nn_inputs(cuda_device, 2048, 4, 1e3, dup=True)
    num_chunks = t_aug.shape[-2] // 2048
    cnt = torch.full_like(cnt, num_chunks)
    ids = torch.arange(num_chunks, dtype=torch.int32, device=cuda_device).repeat(cnt.shape[-1]).expand(ids.shape).contiguous()
    kd, ki = tnn._nn_visits_cuda(cnt, ids, q, t_aug, 2048, True, (query_splits, target_splits))
    torch.cuda.synchronize()
    pd, pi = tnn.nn_visits_plain(cnt, ids, q, t_aug, 2048)
    _assert_same_bits((np_(kd.view(torch.int32)), np_(ki)), (np_(pd.view(torch.int32)), np_(pi)))


@pytest.mark.parametrize("batch", [0, 4])
@pytest.mark.parametrize("bt", [512, 2048])
def test_nn_kernel_ties_empty_tiles_and_every_chunk(cuda_device, bt, batch):
    """Every chunk visited by every tile over targets that each have an
    exact twin in another chunk: every query's minimum ties across slices
    and blocks, and the lower index must win. Then the same with every
    third tile's visit count set to 0: those tiles give (+inf, 0)."""
    cnt, ids, q, t_aug = _nn_inputs(cuda_device, bt, batch, 1e3, dup=True)
    num_chunks = t_aug.shape[-2] // bt
    cnt = torch.full_like(cnt, num_chunks)
    ids = torch.arange(num_chunks, dtype=torch.int32, device=cuda_device).repeat(cnt.shape[-1]).expand(ids.shape).contiguous()
    k, p = _nn_kernel_and_plain(cnt, ids, q, t_aug, bt)
    _assert_same_bits(k, p)
    m = t_aug.shape[-2] // 2
    valid = np_(torch.all(q[..., :3].abs() < 1e7, dim=-1) & (q[..., 3] > 0))
    assert (k[1][valid] < m).all()  # the twin in the first half wins
    cnt = cnt.clone()
    cnt[..., ::3] = 0
    k, p = _nn_kernel_and_plain(cnt, ids, q, t_aug, bt)
    _assert_same_bits(k, p)
    empty = k[0].reshape(k[0].shape[:-1] + (-1, tnn.BQ))[..., ::3, :]
    assert (empty.view(np.float32) == np.inf).all()
    assert not k[1].reshape(empty.shape[:-2] + (-1, tnn.BQ))[..., ::3, :].any()


def test_nn_kernel_back_to_back_calls_reset_the_counters(cuda_device):
    """Two launches on different inputs, queued without a synchronisation
    between them, then a third on the first inputs: each equals its plain
    version, so every launch left the merge counters at 0."""
    a = _nn_inputs(cuda_device, 2048, 4, 2.0, seed=30)
    b = _nn_inputs(cuda_device, 2048, 4, 2.0, seed=40)
    outs = [tnn.nn_visits_batched(*x, 2048) for x in (a, b, a)]
    torch.cuda.synchronize()
    with dispatch.no_kernels():
        plain = [tnn.nn_visits_batched(*x, 2048) for x in (a, b)]
    for (kd, ki), (pd, pi) in zip(outs, plain + plain[:1]):
        np.testing.assert_array_equal(np_(kd.view(torch.int32)), np_(pd.view(torch.int32)))
        np.testing.assert_array_equal(np_(ki), np_(pi))


@pytest.mark.parametrize("batched", [False, True])
def test_nn_kernel_graph_replay_matches_eager(cuda_device, batched):
    """One call captured in a CUDA graph and replayed twice, with an eager
    call on other inputs in between: every replay equals the eager call on
    the captured inputs, bit for bit."""
    batch = 4 if batched else 0
    x = _nn_inputs(cuda_device, 2048, batch, 2.0, seed=50)
    y = _nn_inputs(cuda_device, 2048, batch, 2.0, seed=60)
    run = tnn.nn_visits_batched if batched else tnn.nn_visits
    eager_d, eager_i = run(*x, 2048)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(*x, 2048)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gd, gi = run(*x, 2048)
    for _ in range(2):
        graph.replay()
        other_d, other_i = run(*y, 2048)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(np_(gd.view(torch.int32)), np_(eager_d.view(torch.int32)))
        np.testing.assert_array_equal(np_(gi), np_(eager_i))
    with dispatch.no_kernels():
        pd, pi = run(*y, 2048)
    np.testing.assert_array_equal(np_(other_d.view(torch.int32)), np_(pd.view(torch.int32)))
    np.testing.assert_array_equal(np_(other_i), np_(pi))


def test_batched_moments_kernels_match_plain_and_single(cuda_device):
    """Kernels B4 (pruned) and B6 (dense) on 4 members with 4 radii, and B5
    on each member: equal to their plain versions and to the single
    kernels B1 and B5. The dense sums equal the pruned ones on every query
    whose count agrees (the pruning may only differ at the radius)."""
    leaves = [0.1, 0.15, 0.2, 0.3]
    xyz, _ = _batch(cuda_device, leaves)
    r2 = torch.tensor([(2.5 * lf) ** 2 for lf in leaves], dtype=torch.float32, device=cuda_device)
    cnt, ids = tmom.prune(xyz, xyz, r2)
    q, t = tmom.pack_operands(xyz, xyz)
    qd, td = tmom.pack_operands(xyz, xyz, bt=tmom.DENSE_BT)
    k4 = tmom.moments_visits_batched(cnt, ids, r2, q, t)
    k6 = tmom.moments_dense_batched(r2, qd, td)
    torch.cuda.synchronize()
    with dispatch.no_kernels():
        p4 = tmom.moments_visits_batched(cnt, ids, r2, q, t)
        p6 = tmom.moments_dense_batched(r2, qd, td)
    valid = np_(torch.all(q[..., :3].abs() < 1e7, dim=-1) & (q[..., 3] > 0))
    np.testing.assert_array_equal(np_(k4)[valid], np_(p4)[valid])
    np.testing.assert_array_equal(np_(k6)[valid], np_(p6)[valid])
    for b in range(xyz.shape[0]):
        k1 = tmom.moments_visits(cnt[b].contiguous(), ids[b].contiguous(), r2[b:b + 1], q[b].contiguous(), t[b].contiguous())
        k5 = tmom.moments_dense(r2[b:b + 1], qd[b].contiguous(), td[b].contiguous())
        np.testing.assert_array_equal(np_(k4[b])[valid[b]], np_(k1)[valid[b]])
        np.testing.assert_array_equal(np_(k6[b])[valid[b]], np_(k5)[valid[b]])
        same = valid[b] & (np_(k5)[:, 9] == np_(k1)[:, 9])
        assert same.mean() > 0.5 * valid[b].mean()
        np.testing.assert_array_equal(np_(k5)[same], np_(k1)[same])


def _moments_inputs(device, batch, every_chunk, leaves=(0.2, 0.15, 0.3, 0.1)):
    """Visit lists and operands of kernel B1 (batch 0) or B4 on voxelised
    tunnel scans (one leaf and radius 2.5 leaf a member), every third
    tile's visit count set to 0; with `every_chunk` every other tile visits
    every chunk."""
    nb = max(batch, 1)
    xyz, _ = _batch(device, leaves[:nb], seeds=(3, 4, 5, 6)[:nb])
    r2 = torch.tensor([(2.5 * lf) ** 2 for lf in leaves[:nb]], dtype=torch.float32, device=device)
    if not batch:
        xyz = xyz[0]
    cnt, ids = tmom.prune(xyz, xyz, r2)
    q, t = tmom.pack_operands(xyz, xyz)
    if every_chunk:
        num_chunks = t.shape[-2] // tmom.MBT
        cnt = torch.full_like(cnt, num_chunks)
        ids = torch.arange(num_chunks, dtype=torch.int32, device=device).repeat(cnt.shape[-1]).expand(ids.shape).contiguous()
    cnt = cnt.clone()
    cnt[..., ::3] = 0
    return cnt, ids, r2, q, t


def _check_b1_b4_bits(single, batched):
    """B1 on `single` and B4 on `batched`: the plain version's sums on every
    row, and every B4 member the sums of B1 on its inputs."""
    k1 = tmom.moments_visits(*single)
    k4 = tmom.moments_visits_batched(*batched)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np_(k1), np_(tmom.moments_visits_plain(*single)))
    np.testing.assert_array_equal(np_(k4), np_(tmom.moments_visits_plain(*batched)))
    cnt, ids, r2, q, t = batched
    for b in range(q.shape[0]):
        kb = tmom.moments_visits(cnt[b].contiguous(), ids[b].contiguous(), r2[b:b + 1],
                                 q[b].contiguous(), t[b].contiguous())
        np.testing.assert_array_equal(np_(kb), np_(k4[b]), err_msg=f"member {b}")


@pytest.mark.parametrize("every_chunk", [False, True], ids=["visit_lists", "every_chunk"])
def test_moments_kernel_grid_matches_plain_bits(cuda_device, every_chunk):
    """The B1/B4 kernel at the grid it launches (two blocks a tile), on B1's
    and B4's inputs with tiles that visit nothing and, or not, tiles that
    visit every chunk: the plain version's bits, and B4 member == B1."""
    single = _moments_inputs(cuda_device, 0, every_chunk)
    assert not tmom.moments_visits_plain(*single)[: tmom.BQ].any()
    _check_b1_b4_bits(single, _moments_inputs(cuda_device, 4, every_chunk))


def _boundary_inputs(device, scales, seed=0):
    """Operands on which only the rounding margin of the kernel's in-tile
    skip test (`apart`) keeps neighbours: per member, 64 query octets of 8
    copies of one point (at `scale` times [-1, 1]^3 from the origin) and,
    beside each, a group of 32 targets at radius 0.3 times 1 +- spread (a
    few rounding units of the f32 gate at 1 m and 40 m; every other group
    wholly beyond the radius), sentinel rows at the end; every tile visits
    every chunk."""
    rng = np.random.default_rng(seed)
    r = np.float32(0.3)
    qs, ts = [], []
    for scale in scales:
        sp = {1.0: 2e-5, 40.0: 2e-3}[scale]
        base = rng.uniform(-1, 1, size=(64, 3)) * scale
        base = base[np.argsort(base[:, 0])]
        dirs = rng.normal(size=(64, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        eps = rng.uniform(-sp, sp, size=(64, 32, 1))
        eps[::2] = np.abs(eps[::2])
        qry = np.repeat(base, 8, axis=0).astype(np.float32)
        tgt = (base[:, None] + dirs[:, None] * float(r) * (1 + eps)).reshape(-1, 3).astype(np.float32)
        qry[-5:] = tgt[-7:] = 1e8
        q, t = tmom.pack_operands(torch.from_numpy(qry).to(device), torch.from_numpy(tgt).to(device))
        qs.append(q)
        ts.append(t)
    q, t = torch.stack(qs), torch.stack(ts)
    nb, num_tiles, num_chunks = len(scales), q.shape[-2] // tmom.BQ, t.shape[-2] // tmom.MBT
    cnt = torch.full((nb, num_tiles), num_chunks, dtype=torch.int32, device=device)
    ids = torch.arange(num_chunks, dtype=torch.int32, device=device).repeat(nb, num_tiles)
    r2 = torch.full((nb,), float(r * r), dtype=torch.float32, device=device)
    return cnt, ids, r2, q, t


@pytest.mark.parametrize("scale", [1.0, 40.0], ids=["near", "far"])
def test_moments_kernel_keeps_neighbours_at_the_radius(cuda_device, scale):
    """The kernel skips a (query octet, 32-target group) pair whose boxes lie
    beyond the radius plus a margin for the gate's rounding. On neighbours
    at the radius to a few rounding units, 1 m and 40 m from the origin,
    B1 and B4 still give the plain version's bits (the plain gate passes
    some pairs beyond the radius and fails some within it)."""
    batched = _boundary_inputs(cuda_device, (scale, 1.0, 40.0, scale), seed=int(scale))
    cnt, ids, r2, q, t = batched
    single = (cnt[0], ids[0], r2[:1], q[0], t[0])
    p = tmom.moments_visits_plain(*single)
    assert p[..., 9].sum() > 0
    _check_b1_b4_bits(single, batched)


def test_moments_kernel_back_to_back_and_graph_replay(cuda_device):
    """B4 on two inputs queued without a synchronisation between them, then
    the first again; then one B1 call captured in a CUDA graph and replayed
    twice around an eager call on other inputs: every result equals the
    plain version's, bit for bit."""
    a = _moments_inputs(cuda_device, 4, False)
    b = _moments_inputs(cuda_device, 4, True)
    outs = [tmom.moments_visits_batched(*x) for x in (a, b, a)]
    torch.cuda.synchronize()
    plain = [tmom.moments_visits_plain(*x) for x in (a, b, a)]
    for k, p in zip(outs, plain):
        np.testing.assert_array_equal(np_(k), np_(p))
    x = _moments_inputs(cuda_device, 0, False)
    y = _moments_inputs(cuda_device, 0, True, leaves=(0.3,))
    eager = tmom.moments_visits(*x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmom.moments_visits(*x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tmom.launches
    with torch.cuda.graph(graph):
        captured = tmom.moments_visits(*x)
    assert tmom.launches == before + 1
    for _ in range(2):
        graph.replay()
        other = tmom.moments_visits(*y)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(np_(captured), np_(eager))
        np.testing.assert_array_equal(np_(other), np_(tmom.moments_visits_plain(*y)))
    np.testing.assert_array_equal(np_(eager), np_(tmom.moments_visits_plain(*x)))


# (queries, targets, radius of each member): shapes at the edges of B5/B6's
# tiling, as in test_torch_batched.py, and fewer targets than splits
DENSE_EDGES = {
    "fewer_targets_than_splits": (130, 700, (0.8, 1.1)),  # one chunk: one 128-target run a split
    "targets_not_a_multiple_of_1024": (128, 1500, (0.8, 0.6)),
    "queries_not_a_multiple_of_64": (100, 2048, (0.8, 0.6)),
    "one_chunk": (64, 1024, (0.8, 1.1)),
    "five_chunks": (192, 5000, (0.8, 0.5)),
    "radius_holds_every_pair": (128, 1100, (100.0, 100.0)),
    "radius_zero": (128, 1100, (0.0, 0.0)),
    "three_members_three_radii": (100, 1500, (0.5, 0.8, 1.1)),
}


def _dense_inputs(device, case, seed=7):
    """B6's packed operands (r2 (B,), q (B, n_pad, 4), t (B, m_pad, 4)) at
    one of DENSE_EDGES: targets N(0, 2^2) per axis, the queries jittered
    copies of targets, a quarter of them exact."""
    n, m, radii = DENSE_EDGES[case]
    rng = np.random.default_rng(seed)
    ts = (rng.normal(size=(len(radii), m, 3)) * 2).astype(np.float32)
    qs = ts[:, rng.choice(m, n, replace=False)].copy()
    qs[:, n // 4:] += rng.normal(scale=0.1, size=qs[:, n // 4:].shape).astype(np.float32)
    q, t = tmom.pack_operands(torch.from_numpy(qs).to(device), torch.from_numpy(ts).to(device), bt=tmom.DENSE_BT)
    r2 = torch.tensor(radii, dtype=torch.float32, device=device) ** 2
    return r2, q, t


def _dense_plain(r2, q, t):
    return tmom.moments_visits_plain(*tmom.dense_visits(q, t), r2, q, t, tmom.DENSE_BT)


@pytest.mark.parametrize("case", list(DENSE_EDGES))
def test_dense_moments_kernels_match_plain_at_edge_shapes(cuda_device, case):
    """Kernels B5 (first member) and B6 (every member) at the edges of the
    tiling, fewer targets than splits included: the plain version's sums
    and counts on every row, and every B6 member the bits of B5 on its
    inputs."""
    r2, q, t = _dense_inputs(cuda_device, case)
    before = (tmom.dense_launches, tmom.dense_batched_launches)
    k6 = tmom.moments_dense_batched(r2, q, t)
    k5 = [tmom.moments_dense(r2[b:b + 1], q[b].contiguous(), t[b].contiguous()) for b in range(q.shape[0])]
    torch.cuda.synchronize()
    assert (tmom.dense_launches, tmom.dense_batched_launches) == (before[0] + q.shape[0], before[1] + 1)
    np.testing.assert_array_equal(np_(k6), np_(_dense_plain(r2, q, t)))
    np.testing.assert_array_equal(np_(k5[0]), np_(_dense_plain(r2[:1], q[0], t[0])))
    for b, kb in enumerate(k5):
        np.testing.assert_array_equal(np_(kb), np_(k6[b]), err_msg=f"member {b}")
    if case == "radius_holds_every_pair":
        valid = np_(q[..., 3] > 0)
        assert (np_(k6[..., 9])[valid] == t.shape[-2] - int((t[0, :, 3] == tmom.PAD_T2).sum())).all()


def test_dense_moments_kernel_batch_of_one_equals_single(cuda_device):
    """B6 at B = 1 gives the bits of B5."""
    r2, q, t = _dense_inputs(cuda_device, "five_chunks")
    k6 = tmom.moments_dense_batched(r2[:1], q[:1].contiguous(), t[:1].contiguous())
    k5 = tmom.moments_dense(r2[:1], q[0].contiguous(), t[0].contiguous())
    torch.cuda.synchronize()
    assert k6.shape == (1,) + k5.shape
    np.testing.assert_array_equal(np_(k6[0]), np_(k5))
    np.testing.assert_array_equal(np_(k5), np_(_dense_plain(r2[:1], q[0], t[0])))


def test_dense_moments_kernel_back_to_back_leaves_the_counters_at_zero(cuda_device):
    """B6 on two inputs queued without a synchronisation between them, then
    the first again, then B5: each equals its plain version bit for bit,
    the repeat equals the first call, and the merge counters are all 0
    afterwards."""
    a = _dense_inputs(cuda_device, "five_chunks", seed=1)
    b = _dense_inputs(cuda_device, "three_members_three_radii", seed=2)
    outs = [tmom.moments_dense_batched(*x) for x in (a, b, a)]
    single = tmom.moments_dense(a[0][:1], a[1][0].contiguous(), a[2][0].contiguous())
    torch.cuda.synchronize()
    for k, x in zip(outs, (a, b, a)):
        np.testing.assert_array_equal(np_(k), np_(_dense_plain(*x)))
    np.testing.assert_array_equal(np_(outs[2]), np_(outs[0]))
    np.testing.assert_array_equal(np_(single), np_(outs[0][0]))
    assert not tmom._merge_counters(a[1].device, 1).any()


def test_dense_moments_kernel_on_a_side_stream(cuda_device):
    """B5 and B6 launched on a non-default stream (on inputs made on the
    default one) give the plain version's bits."""
    r2, q, t = _dense_inputs(cuda_device, "targets_not_a_multiple_of_1024", seed=3)
    q0, t0 = q[0].contiguous(), t[0].contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k6 = tmom.moments_dense_batched(r2, q, t)
        k5 = tmom.moments_dense(r2[:1], q0, t0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np_(k6), np_(_dense_plain(r2, q, t)))
    np.testing.assert_array_equal(np_(k5), np_(_dense_plain(r2[:1], q0, t0)))
    with torch.cuda.stream(side):
        assert not tmom._merge_counters(q.device, 1).any()


def test_dense_moments_kernel_on_two_streams_at_once(cuda_device):
    """B6 queued on two streams at once, four calls each with no
    synchronisation between them, so launches of the two streams may
    overlap: each stream merges on counters of its own, every call gives
    the plain version's bits, and both streams' counters end at 0."""
    a = _dense_inputs(cuda_device, "five_chunks", seed=4)
    b = _dense_inputs(cuda_device, "three_members_three_radii", seed=5)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = {0: [], 1: []}
    for _ in range(4):
        for n, (s, x) in enumerate(zip(streams, (a, b))):
            with torch.cuda.stream(s):
                outs[n].append(tmom.moments_dense_batched(*x))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for n, x in enumerate((a, b)):
        plain = np_(_dense_plain(*x))
        for k in outs[n]:
            np.testing.assert_array_equal(np_(k), plain, err_msg=f"stream {n}")
    counters = []
    for s in streams:
        with torch.cuda.stream(s):
            counters.append(tmom._merge_counters(a[1].device, 1))
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert not any(c.any() for c in counters)


def _small_cfg():
    return cfg_mod.LocusConfig(
        scan_capacity=1024,
        raw_scan_capacity=4096,
        points_to_process_in_callback=800,
        filtering=cfg_mod.FilterConfig(body_filter=True, normals_k=12),
        mapper=cfg_mod.MapperConfig(map_capacity=8192, keyframe_capacity=1024, map_voxel_leaf=0.1),
    )


def test_replay_defaults_to_the_card_and_matches_plain(cuda_device):
    """run_sequence with no device runs on the card through the kernels,
    and gives the same poses as the plain versions on the card."""
    seq = make_tunnel_sequence(num_scans=6, azimuth_steps=256, step=0.3, seed=1)
    cfg = _small_cfg()
    tmom.launches = 0
    before = dict(tnn.launches)
    poses, _, _, state = runner.run_sequence(seq, cfg, return_state=True)
    assert state.map.cloud.xyz.is_cuda
    assert tmom.launches > 0 and all(tnn.launches[b] > before[b] for b in before)
    with dispatch.no_kernels():
        plain, _, _ = runner.run_sequence(seq, cfg, device=cuda_device)
    np.testing.assert_array_equal(poses, plain)


def test_init_state_defaults_to_the_card(cuda_device):
    state = pipeline.init_state(_small_cfg())
    assert state.voxel_leaf.device.type == "cuda"


def test_batched_replay_matches_single_on_the_card(cuda_device):
    """make_batched_replay through kernels B3 and B4 gives each robot the
    poses of its make_scan_replay, bit for bit, with B4 and B3 at BT
    launched once per tick."""
    cfg = _small_cfg()
    seqs = [make_tunnel_sequence(num_scans=5, azimuth_steps=256, step=s, seed=i)
            for i, s in enumerate((0.3, 0.4, 0.35))]
    packed = [runner.pack_sequence(s, cfg) for s in seqs]
    single = runner.make_scan_replay(cfg)
    ref = []
    for s, p in zip(seqs, packed):
        st = pipeline.init_state(cfg, initial_pose=torch.as_tensor(s.gt_poses[0], dtype=torch.float32))
        ref.append(np_(single(st, p)[1][0]))
    states = pipeline.init_states(cfg, np.stack([s.gt_poses[0] for s in seqs]))
    tmom.batched_launches = 0
    before = dict(tnn.batched_launches)
    _, (poses, _, _) = runner.make_batched_replay(cfg)(states, runner.stack_packed(packed))
    assert tmom.batched_launches == 5
    assert tnn.batched_launches[tnn.BT] - before[tnn.BT] == 5
    assert tnn.batched_launches[tnn.SCAN_BT] > before[tnn.SCAN_BT]
    for b in range(len(seqs)):
        np.testing.assert_array_equal(np_(poses[:, b]), ref[b])


# -- the other single-card paths: NDT, the voxel-hash map, LOAM features --

def _path_cfg(name):
    """_small_cfg on one of the single-card paths (chip_smoke.path_config)."""
    import dataclasses

    rep = dataclasses.replace
    cfg = _small_cfg()

    def both(c, **kw):
        return c.replace(odometry=rep(c.odometry, **kw),
                         localization=rep(c.localization, registration=rep(c.localization.registration, **kw)))

    if name == "ndt":
        return both(cfg, registration_method="ndt")
    if name == "features":
        return both(cfg.replace(filtering=rep(cfg.filtering, extract_features=True, feature_width=256)),
                    covariance_mode="adaptive")
    return cfg.replace(mapper=rep(cfg.mapper, structure="voxel_hash"))


def _room(device, seed=3, shift=(0.12, -0.06, 0.04)):
    from locus_tpu_torch.io import synthetic

    xyz, nrm = synthetic.hollow_cube(step=0.15, side=4.0, jitter=0.01, seed=seed)
    target = PointCloud.from_points(xyz, capacity=2048, normals=nrm, device=device)
    src = torch.where(target.mask[:, None], target.xyz - torch.tensor(shift, device=device), target.xyz)
    return PointCloud(src, target.normals, target.intensity, target.mask), target


@pytest.mark.parametrize("optimizer", ["irls", "newton"])
def test_ndt_on_the_card_matches_the_cpu(cuda_device, optimizer):
    """ndt_register (irls; newton with the Moré–Thuente search) on the card
    against the CPU port: transform within 1e-4 m / 1e-4 rad (exp, sums and
    solves round differently on the two devices), the same iterations, and
    the final pass through kernel B2 at SCAN_BT."""
    from locus_tpu_torch.registration.ndt import ndt_register

    cfg = cfg_mod.RegistrationConfig(registration_method="ndt", ndt_resolution=1.0, iterations=30,
                                     ndt_optimizer=optimizer)
    src, tgt = _room(cuda_device)
    before = tnn.launches[tnn.SCAN_BT]
    card = ndt_register(src, tgt, cfg=cfg)
    assert tnn.launches[tnn.SCAN_BT] == before + 1
    cpu = ndt_register(PointCloud(*(a.cpu() for a in src)), PointCloud(*(a.cpu() for a in tgt)), cfg=cfg)
    d = np_(card.transform) - np_(cpu.transform)
    assert np.abs(d[:3, 3]).max() < 1e-4 and np.abs(d[:3, :3]).max() < 1e-4, d
    assert int(card.iterations) == int(cpu.iterations)
    np.testing.assert_array_equal(np_(card.corr_mask), np_(cpu.corr_mask))


def _keyframes(device, n=4, capacity=1024):
    """Voxelised tunnel scans at a 0.05 m leaf moved along the tunnel: many
    points of one 0.1 m map voxel in each keyframe."""
    seq = make_tunnel_sequence(num_scans=n, azimuth_steps=450, step=0.3, seed=4)
    out = []
    for i in range(n):
        xyz = seq.scans[i][seq.scan_valid[i]].astype(np.float32)
        T = seq.gt_poses[i].astype(np.float32)
        pc = PointCloud.from_points(xyz @ T[:3, :3].T + T[:3, 3], capacity=max(capacity, xyz.shape[0]), device=device)
        out.append(voxel.voxel_downsample(pc, 0.05, capacity=capacity, with_attributes=False))
    return out


@pytest.mark.parametrize("map_capacity", [8192, 512])
def test_voxel_hash_on_the_card_matches_the_cpu(cuda_device, map_capacity):
    """Inserts (several points per new voxel, and at 512 slots collisions
    everywhere) and a refresh on the card give the CPU's store exactly:
    the winner of a slot written several times is picked the same way."""
    from locus_tpu_torch.mapping import voxel_hash_map as vh

    mcfg = cfg_mod.MapperConfig(map_capacity=map_capacity, keyframe_capacity=1024, map_voxel_leaf=0.1)
    card, cpu = vh.init_map(mcfg), vh.init_map(mcfg, device="cpu")
    assert card.nn_aug.is_cuda
    for kf in _keyframes(cuda_device):
        card = vh.insert_keyframe(card, kf, mcfg)
        cpu = vh.insert_keyframe(cpu, PointCloud(*(a.cpu() for a in kf)), mcfg)
    for stage in ("insert", "refresh"):
        for a, b in zip(card, cpu):
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(np_(x), np_(y), err_msg=stage)
        pos = torch.tensor([1.0, 0.0, 0.0])
        card = vh.refresh_msw(card, pos.to(cuda_device), mcfg)
        cpu = vh.refresh_msw(cpu, pos, mcfg)


def test_nn_kernel_on_the_voxel_hash_operand_matches_plain(cuda_device):
    """Kernel B2 at BT on the voxel-hash map's operand, where every chunk
    spans the window so a tile visits (nearly) every chunk: score bits and
    index equal to the plain version's."""
    from locus_tpu_torch.mapping import voxel_hash_map as vh

    mcfg = cfg_mod.MapperConfig(map_capacity=1 << 15, keyframe_capacity=4096, map_voxel_leaf=0.1)
    st = vh.init_map(mcfg)
    kfs = _keyframes(cuda_device, n=4, capacity=4096)
    for kf in kfs:
        st = vh.insert_keyframe(st, kf, mcfg)
    q = kfs[-1].xyz + torch.tensor([0.03, -0.02, 0.01], device=cuda_device)
    cnt, ids = tnn.visit_lists(*tnn.tile_boxes(q), st.chunk_min, st.chunk_max, 2.0 * 2.0)
    num_chunks = st.nn_aug.shape[0] // tnn.BT
    assert float(cnt.float().mean()) > 0.9 * num_chunks
    qp = tnn.pack_query(q)
    before = tnn.launches[tnn.BT]
    kd, ki = tnn.nn_visits(cnt, ids, qp, st.nn_aug, tnn.BT)
    torch.cuda.synchronize()
    assert tnn.launches[tnn.BT] == before + 1
    pd, pi = tnn.nn_visits_plain(cnt, ids, qp, st.nn_aug, tnn.BT)
    np.testing.assert_array_equal(np_(kd).view(np.int32), np_(pd).view(np.int32))
    np.testing.assert_array_equal(np_(ki), np_(pi))


def test_features_and_knn_normals_on_the_card_match_the_cpu(cuda_device):
    """The LOAM extractor on the card labels as on the CPU (bin-centred
    sweep); kNN normals within 1e-4 where the normal is defined to f32
    precision (the distance matrices round differently on the two
    devices)."""
    from locus_tpu_torch.ops import features, normals

    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=450, step=0.3, seed=3)
    xyz = seq.scans[0][seq.scan_valid[0]].astype(np.float32)
    cpu = PointCloud.from_points(xyz, capacity=8192)
    card = PointCloud(*(a.to(cuda_device) for a in cpu))
    fc, fg = features.extract_features(cpu, width=450), features.extract_features(card, width=450)
    for f in ("valid", "label", "src_idx", "xyz"):
        np.testing.assert_array_equal(np_(getattr(fg, f)), np_(getattr(fc, f)), err_msg=f)
    pc = voxel.voxel_downsample(cpu, 0.2, capacity=2048, with_attributes=False)
    nc = normals.estimate_normals(pc, k=20)
    ng = normals.estimate_normals(PointCloud(*(a.to(cuda_device) for a in pc)), k=20)
    lam = np.linalg.eigvalsh(np_(normals.knn_covariance(pc.xyz, pc.mask, 20)).astype(np.float64))
    defined = np_(pc.mask) & (lam[:, 1] - lam[:, 0] > 1e-2 * lam[:, 2])
    assert defined.sum() > 0.9 * np_(pc.mask).sum()
    np.testing.assert_allclose(np_(ng.normals)[defined], np_(nc.normals)[defined], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["ndt", "features", "voxel_hash"])
def test_paths_on_the_card_match_plain(cuda_device, name):
    """Each path's replay through the kernels equals its replay through the
    plain versions on the card, and launches B2 (B1 except on features)."""
    seq = make_tunnel_sequence(num_scans=5, azimuth_steps=256, step=0.3, seed=1)
    cfg = _path_cfg(name)
    tmom.launches = 0
    before = dict(tnn.launches)
    poses, _, _ = runner.run_sequence(seq, cfg)
    assert all(tnn.launches[b] > before[b] for b in before)
    assert (tmom.launches > 0) == (name != "features")
    with dispatch.no_kernels():
        plain, _, _ = runner.run_sequence(seq, cfg, device=cuda_device)
    np.testing.assert_array_equal(poses, plain)


# -- live serving and the SLAM backend -------------------------------------

def test_reanchored_map_nearest_matches_plain_and_brute_force(cuda_device):
    """After a loop-closure reanchor that moves a keyframe out of its
    chunk's old box, B2 at BT on the rebuilt operand and boxes equals its
    plain version and a brute-force search (the boxes were rebuilt)."""
    from locus_tpu_torch.geometry import se3
    from locus_tpu_torch.mapping import keyframe_map

    rng = np.random.default_rng(0)
    mcfg = cfg_mod.MapperConfig(map_capacity=8192, keyframe_capacity=2048, map_voxel_leaf=0.05)
    mp = keyframe_map.init_map(mcfg)
    for k in range(3):
        pts = (rng.normal(size=(2048, 3)) * 2 + [20.0 * k, 0, 0]).astype(np.float32)
        mp = keyframe_map.insert_keyframe(mp, PointCloud.from_points(pts, capacity=2048, device=cuda_device), mcfg)
    corr = torch.eye(4, device=cuda_device).repeat(3, 1, 1)
    corr[1, :3, 3] = torch.tensor([0.3, 10.0, 0.1])
    corr[2] = se3.make_transform(se3.so3_exp(torch.tensor([0.0, 0.0, 0.1], device=cuda_device)),
                                 torch.tensor([-0.1, 0.4, 0.0], device=cuda_device))
    mp = keyframe_map.reanchor(mp, corr, mcfg)
    xyz, kf = np_(mp.cloud.xyz), np_(mp.kf_index)
    blocks = []
    for k in range(3):
        pick = xyz[kf == k][rng.choice(int((kf == k).sum()), 192)] + rng.normal(size=(192, 3)) * 0.3
        blocks.append(pick[np.argsort(pick[:, 1])])
    q = torch.as_tensor(np.concatenate(blocks).astype(np.float32), device=cuda_device)
    before = tnn.launches[tnn.BT]
    d2, idx = keyframe_map._map_nearest(mp, q, 1.5)
    torch.cuda.synchronize()
    assert tnn.launches[tnn.BT] == before + 1
    with dispatch.no_kernels():
        pd2, pidx = keyframe_map._map_nearest(mp, q, 1.5)
    np.testing.assert_array_equal(np_(d2), np_(pd2))
    np.testing.assert_array_equal(np_(idx), np_(pidx))
    slot = np.nonzero(np_(mp.cloud.mask))[0]
    full = ((np_(q)[:, None, :].astype(np.float64) - xyz[slot][None]) ** 2).sum(-1)
    hit = full.min(1) <= 1.5 ** 2
    np.testing.assert_array_equal(np.isfinite(np_(d2)), hit)
    np.testing.assert_array_equal(np_(idx)[hit], slot[full.argmin(1)[hit]])


def test_closure_gicp_matches_plain(cuda_device):
    """A loop-closure verification (GICP of two keyframe clouds preprocessed
    at the fixed 0.5 m leaf, on B2 at SCAN_BT) equals its plain run."""
    from locus_tpu_torch.backend import PoseGraphBackend

    cfg = _small_cfg()
    seq = make_tunnel_sequence(num_scans=12, azimuth_steps=900, step=0.3, seed=4)

    def cloud(i):
        xyz, mask = runner.pack_scan(seq.scans[i], seq.scan_valid[i], cfg.raw_scan_capacity)
        return runner.verification_cloud(torch.as_tensor(xyz, device=cuda_device),
                                          torch.as_tensor(mask, device=cuda_device), cfg)

    def verify():
        b = PoseGraphBackend(loop_distance=10.0, min_index_gap=1, loop_fitness_max=1.0)
        for i in (0, 11):
            b.add_keyframe(float(seq.stamps[i]), seq.gt_poses[i], cloud=cloud(i))
        return b.verify_loop(0, 1)

    before = tnn.launches[tnn.SCAN_BT]
    T = verify()
    assert T is not None and tnn.launches[tnn.SCAN_BT] > before
    with dispatch.no_kernels():
        plain = verify()
    np.testing.assert_array_equal(T, plain)


def test_live_session_matches_replay_and_prewarm_holds(cuda_device):
    """LiveSession on the card (one upload, one fetch a scan) gives the
    replay's poses bit for bit when fed the replay's sensor windows; after
    prewarm_loop_closure and the backend's prewarm, serving and a closure
    push-back build no kernel and allocate no counter buffer."""
    from locus_tpu_torch.backend import PoseGraphBackend
    from locus_tpu_torch.io.dataset import sensor_windows_for_scan
    from locus_tpu_torch.live import LiveSession
    from locus_tpu_torch.ops.kernels import build

    cfg = _small_cfg()
    seq = make_tunnel_sequence(num_scans=6, azimuth_steps=256, step=0.3, seed=1)
    replay, _, _ = runner.run_sequence(seq, cfg)
    warm = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0])
    warm.process_scan(float(seq.stamps[0]), seq.scans[0], seq.scan_valid[0])
    warm.prewarm_loop_closure()
    xyz, mask = runner.pack_scan(seq.scans[0], seq.scan_valid[0], cfg.raw_scan_capacity)
    backend = PoseGraphBackend()
    backend.prewarm(runner.verification_cloud(torch.as_tensor(xyz).cuda(), torch.as_tensor(mask).cuda(), cfg))
    counts = (build.builds, len(build._libs), tnn.buffer_allocations)
    sess = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0])
    poses = []
    for i in range(len(seq)):
        (imu_s, imu_q), (odom_s, odom_p) = sensor_windows_for_scan(seq, i)
        for s, q in zip(imu_s, imu_q):
            if np.isfinite(s):
                sess.feed_imu(s, q)
        for s, p in zip(odom_s, odom_p):
            if np.isfinite(s):
                sess.feed_odom(s, p)
        poses.append(sess.process_scan(float(seq.stamps[i]), seq.scans[i], seq.scan_valid[i])[0])
    np.testing.assert_array_equal(np.stack(poses).astype(np.float64), replay)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 0.05
    sess.apply_loop_closure(shift @ poses[-1], np.tile(shift, (3, 1, 1)))
    sess.process_scan(float(seq.stamps[-1]) + 0.1, seq.scans[-1], seq.scan_valid[-1])
    assert (build.builds, len(build._libs), tnn.buffer_allocations) == counts
