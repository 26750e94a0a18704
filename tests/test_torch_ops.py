"""The port's preprocessing ops against the JAX package: crop box, voxel
grid (same mask and point order; centroids within 1e-5 m, the f32
rounding of per-voxel sums taken in another order) and the dense 1-NN
reference."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.ops import filters as jfilters, neighbors as jneighbors, voxel as jvoxel
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.ops import filters as tfilters, neighbors as tneighbors, voxel as tvoxel
from tests.torch_helpers import np_, to_torch, torch_cloud


def _scan(capacity=4096, seed=2):
    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=256, step=0.3, seed=seed)
    xyz = seq.scans[0][seq.scan_valid[0]][:capacity].astype(np.float32)
    return JPC.from_points(jnp.asarray(xyz), capacity=capacity)


def _clouds_match(t, j, atol):
    m = np_(j.mask)
    np.testing.assert_array_equal(np_(t.mask), m)
    np.testing.assert_allclose(np_(t.xyz)[m], np_(j.xyz)[m], atol=atol, rtol=0)
    np.testing.assert_array_equal(np_(t.xyz)[~m], np_(j.xyz)[~m])
    np.testing.assert_allclose(np_(t.normals), np_(j.normals), atol=atol, rtol=0)
    np.testing.assert_allclose(np_(t.intensity), np_(j.intensity), atol=atol, rtol=0)


@pytest.mark.parametrize("negative", [True, False])
def test_crop_box_matches(negative):
    j = _scan()
    box = ((-3.0, -1.5, -1.0), (4.0, 1.5, 1.0))
    jo = jfilters.crop_box(j, *box, negative=negative)
    to = tfilters.crop_box(torch_cloud(j), *box, negative=negative)
    _clouds_match(to, jo, 0.0)


@pytest.mark.parametrize("leaf,capacity", [(0.1, None), (0.2, 1024), (0.45, 1024), (0.05, 512)])
def test_voxel_downsample_matches(leaf, capacity):
    j = _scan()
    jo = jvoxel.voxel_downsample(j, jnp.float32(leaf), capacity=capacity, with_attributes=False)
    to = tvoxel.voxel_downsample(torch_cloud(j), to_torch(np.float32(leaf)), capacity=capacity, with_attributes=False)
    _clouds_match(to, jo, 1e-5)


def test_voxel_downsample_attributes_match(rng):
    j = _scan(capacity=2048)
    n = j.capacity
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    j = JPC(j.xyz, jnp.asarray(nrm), jnp.asarray(rng.uniform(size=(n,)).astype(np.float32)), j.mask)
    jo = jvoxel.voxel_downsample(j, 0.3, capacity=1024)
    to = tvoxel.voxel_downsample(torch_cloud(j), 0.3, capacity=1024)
    _clouds_match(to, jo, 1e-5)


def test_voxel_debug_check_rejects_attributes(rng, monkeypatch):
    monkeypatch.setenv("LOCUS_DEBUG_CHECKS", "1")
    t = torch_cloud(_scan(capacity=512))
    t = t._replace(intensity=t.intensity + 1.0)
    with pytest.raises(ValueError):
        tvoxel.voxel_downsample(t, 0.2, with_attributes=False)
    assert os.environ["LOCUS_DEBUG_CHECKS"] == "1"


def test_voxel_keys_and_adaptive_leaf_match(rng):
    j = _scan(capacity=512)
    np.testing.assert_array_equal(
        np_(tvoxel.voxel_keys(to_torch(j.xyz), to_torch(j.mask), 0.2)),
        np_(jvoxel.voxel_keys(j.xyz, j.mask, 0.2)),
    )
    for n in (100, 2999, 3000, 9000):
        a = jvoxel.adaptive_leaf_update(jnp.float32(0.2), jnp.int32(n), 3000)
        b = tvoxel.adaptive_leaf_update(to_torch(np.float32(0.2)), to_torch(np.int32(n)), 3000)
        assert float(a[0]) == float(b[0]) and bool(a[1]) == bool(b[1])


def test_pairwise_sqdist_and_nearest_match(rng):
    q = (rng.normal(size=(200, 3)) * 3).astype(np.float32)
    t = (rng.normal(size=(700, 3)) * 3).astype(np.float32)
    np.testing.assert_allclose(
        np_(tneighbors.pairwise_sqdist(to_torch(q), to_torch(t))),
        np_(jneighbors.pairwise_sqdist(jnp.asarray(q), jnp.asarray(t))),
        atol=1e-4, rtol=0,
    )
    jd, ji = jneighbors.nearest(jnp.asarray(q), jnp.asarray(t))
    td, ti = tneighbors.nearest(to_torch(q), to_torch(t), chunk=256)
    np.testing.assert_allclose(np_(td), np_(jd), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np_(ti), np_(ji))
