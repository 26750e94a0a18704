"""The port's LOAM feature extractor against `locus_tpu.ops.features`, stage
by stage, on simulated VLP-16 sweeps of the tunnel (tests/test_features.py
holds the JAX package to its analytic scenes).

The sweeps' rays lie at bin centres, in azimuth and in elevation, so no
point sits on a bin edge where an ulp of `atan2` could move it (the two
frameworks' `atan2` may differ by one). Tolerances: the range image's
cells, validity and source indices exactly, also with extra points in
taken cells (a farther point, and an exact copy: the nearer point wins,
then the lower index); ring compaction, exclusions, picks, labels and the
feature clouds exactly; curvature within 1e-5 relative (sums of squares
XLA may fuse into multiply-adds)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu.ops import features as jf
from locus_tpu_torch.ops import features as tf
from tests.torch_helpers import np_, torch_cloud

WIDTH = 450


def sweep(extra=False, seed=3, capacity=8192):
    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=WIDTH, step=0.3, seed=seed)
    xyz = seq.scans[0][seq.scan_valid[0]].astype(np.float32)
    if extra:
        # a farther point and an exact copy in taken cells
        xyz = np.concatenate([xyz, xyz[::7] * np.float32(1.25), xyz[::11]])
    return JPC.from_points(jnp.asarray(xyz[:capacity]), capacity=capacity)


@pytest.fixture(scope="module", params=[False, True], ids=["sweep", "sweep_extra_points"])
def clouds(request):
    j = sweep(extra=request.param)
    return j, torch_cloud(j)


def test_range_image_matches(clouds):
    j, t = clouds
    jg, jv, js = jf.to_range_image(j, WIDTH, return_index=True)
    tg, tv, ts = tf.to_range_image(t, WIDTH, return_index=True)
    np.testing.assert_array_equal(np_(tv), np_(jv))
    np.testing.assert_array_equal(np_(ts), np_(js))
    np.testing.assert_array_equal(np_(tg), np_(jg))
    assert np_(tv).sum() > 2000
    jg2, jv2 = jf.to_range_image(j, WIDTH)
    tg2, tv2 = tf.to_range_image(t, WIDTH)
    np.testing.assert_array_equal(np_(tv2), np_(jv2))
    np.testing.assert_array_equal(np_(tg2), np_(jg2))


def test_compaction_curvature_exclusions_match(clouds):
    j, t = clouds
    jc = jf._compact_rings(*jf.to_range_image(j, WIDTH, return_index=True))
    tc = tf._compact_rings(*tf.to_range_image(t, WIDTH, return_index=True))
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(np_(a), np_(b))
    jcurv, jcv = jf.compute_curvature(jc[0], jc[1])
    tcurv, tcv = tf.compute_curvature(tc[0], tc[1])
    np.testing.assert_array_equal(np_(tcv), np_(jcv))
    m = np_(jcv)
    np.testing.assert_allclose(np_(tcurv)[m], np_(jcurv)[m], rtol=1e-5, atol=1e-9)
    assert np.isinf(np_(tcurv)[~m]).all()
    np.testing.assert_array_equal(np_(tf.unreliable_mask(tc[0], tc[1])), np_(jf.unreliable_mask(jc[0], jc[1])))


def test_greedy_pick_matches():
    """The picker on its own, on scores with exact ties (argmax takes the
    first maximum in both) and a gap pattern that stops suppression waves."""
    rng = np.random.default_rng(0)
    rings, regions, rw = 4, 6, 20
    score = rng.integers(0, 5, size=(rings, regions * rw)).astype(np.float32)
    elig = rng.uniform(size=score.shape) < 0.7
    gap = rng.uniform(size=score.shape) < 0.2
    for picks, promote in ((3, 1), (8, 2)):
        jl, js = jf._greedy_pick(jnp.asarray(score), jnp.asarray(elig), jnp.zeros_like(jnp.asarray(elig)),
                                 jnp.asarray(gap), regions, rw, picks, promote, 1, 2)
        tl, ts = tf._greedy_pick(torch.as_tensor(score), torch.as_tensor(elig), torch.zeros(elig.shape, dtype=torch.bool),
                                 torch.as_tensor(gap), regions, rw, picks, promote, 1, 2)
        np.testing.assert_array_equal(np_(tl), np_(jl))
        np.testing.assert_array_equal(np_(ts), np_(js))


def test_labels_and_feature_clouds_match(clouds):
    j, t = clouds
    jg = jf.extract_features(j, width=WIDTH)
    tg = tf.extract_features(t, width=WIDTH)
    for f in ("xyz", "valid", "label", "src_idx"):
        np.testing.assert_array_equal(np_(getattr(tg, f)), np_(getattr(jg, f)), err_msg=f)
    lab = np_(tg.label)
    for v in (tf.SHARP, tf.LESS_SHARP, tf.FLAT, tf.LESS_FLAT):
        assert (lab == v).sum() > 0, v
    rng = np.random.default_rng(1)
    n = j.capacity
    src = JPC(j.xyz, jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
              jnp.asarray(rng.uniform(size=(n,)).astype(np.float32)), j.mask)
    for source in (None, src):
        je, jp = jf.feature_clouds(jg, edge_capacity=256, planar_capacity=4096, source=source)
        te, tp = tf.feature_clouds(tg, edge_capacity=256, planar_capacity=4096,
                                   source=None if source is None else torch_cloud(source))
        for a, b in ((te, je), (tp, jp)):
            for f in ("xyz", "normals", "intensity", "mask"):
                np.testing.assert_array_equal(np_(getattr(a, f)), np_(getattr(b, f)), err_msg=f)
