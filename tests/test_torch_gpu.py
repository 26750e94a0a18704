"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the same inputs, and the pipeline's entry points on the card.

Every test here takes the `cuda_device` fixture and skips without a card.
This file imports neither JAX nor `locus_tpu`, so it also runs on a
machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: exact. Both kernels round their scores and gates in the same
steps as their plain versions, and the moments kernel sums its f32
features in float64, where the order of summation does not matter.
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
