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
