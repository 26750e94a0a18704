"""The port's k-NN search, kNN normals, filters and GICP covariance modes
against the JAX package (`locus_tpu.ops.{neighbors,normals,filters}`,
`locus_tpu.registration.gicp`).

Tolerances:
- `knn`: squared distances within 1e-5 m^2 plus 1e-6 of |q|^2 + |t|^2
  (the expanded form's f32 rounding); indices equal wherever the k+1
  nearest distances are twice that rounding apart (a near tie may swap neighbours,
  the distance matrices rounding differently); `radius_count` exactly, on
  a fixture with no pair within 1e-5 m of the radius.
- kNN normals: within 1e-4 of JAX's where the normal is well defined (see
  the test).
- The outlier filters and the passthrough: masks exactly.
- `random_sample`: statistically, not bitwise (torch's generator is not
  the JAX PRNG): the kept fraction within 4 sigma of the binomial, and the
  same seed gives the same draw.
- GICP covariances (`adaptive`, `recompute`) within 1e-5; `inv3x3` within
  1e-5 relative; GICP in both modes and with explicit covariances within
  1e-4 m / 1e-4 rad of JAX with equal iteration counts.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu.config import RegistrationConfig as JRC
from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.geometry import se3 as jse3
from locus_tpu.io import synthetic
from locus_tpu.ops import filters as jfilters, neighbors as jneighbors, normals as jnormals
from locus_tpu.ops.dispatch import force_pallas
from locus_tpu.registration import gicp as jgicp
from locus_tpu_torch.config import RegistrationConfig as TRC
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.ops import filters as tfilters, neighbors as tneighbors, normals as tnormals
from locus_tpu_torch.registration import gicp as tgicp
from tests.torch_helpers import np_, pose_diff, to_torch, torch_cloud


def _scan(capacity=2048, seed=2, azimuth_steps=256):
    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=azimuth_steps, step=0.3, seed=seed)
    xyz = seq.scans[0][seq.scan_valid[0]][: capacity - 64].astype(np.float32)
    rng = np.random.default_rng(seed)
    # a few isolated points: outliers for both filters
    xyz = np.concatenate([xyz, rng.uniform(-20, 20, size=(40, 3)).astype(np.float32)])
    return JPC.from_points(jnp.asarray(xyz), capacity=capacity)


@pytest.mark.parametrize("k,chunk", [(1, 4096), (10, 4096), (20, 512)])
def test_knn_matches(k, chunk):
    j = _scan()
    jd, ji = jneighbors.knn(j.xyz, j.xyz, k=k, chunk=chunk)
    td, ti = tneighbors.knn(to_torch(j.xyz), to_torch(j.xyz), k=k, chunk=chunk)
    jd, ji, td, ti = np_(jd), np_(ji), np_(td), np_(ti)
    m = np_(j.mask)
    # the expanded |q|^2 + |t|^2 - 2 q.t rounds at f32 eps of the norms
    x = np_(j.xyz).astype(np.float64)
    scale = (x * x).sum(1)[:, None] + (x * x).sum(1)[ji]
    assert np.all(np.abs(td - jd)[m] <= (1e-5 + 1e-6 * scale)[m])
    # indices: equal where no near tie can reorder them
    full = np_(tneighbors.pairwise_sqdist(to_torch(j.xyz), to_torch(j.xyz)))
    srt = np.sort(full, axis=1)
    thr = 1e-5 + 4e-6 * (x * x).sum(1)
    apart = np.all(np.diff(srt[:, : k + 1], axis=1) > thr[:, None], axis=1) & m
    assert apart.sum() > 0.3 * m.sum()
    np.testing.assert_array_equal(ti[apart], ji[apart])


def test_radius_count_and_gather_match():
    rng = np.random.default_rng(4)
    q = rng.uniform(0, 3, size=(300, 3)).astype(np.float32)
    t = rng.uniform(0, 3, size=(700, 3)).astype(np.float32)
    d = np.sqrt(((q[:, None].astype(np.float64) - t[None]) ** 2).sum(-1))
    # the radius: the middle of the widest gap between pair distances
    # near 0.4 m, so no pair lies within rounding of it
    near = np.sort(d[(d > 0.35) & (d < 0.45)].ravel())
    g = np.argmax(np.diff(near))
    r = float(0.5 * (near[g] + near[g + 1]))
    assert np.abs(d - r).min() > 1e-5
    np.testing.assert_array_equal(
        np_(tneighbors.radius_count(to_torch(q), to_torch(t), r, chunk=256)),
        np_(jneighbors.radius_count(jnp.asarray(q), jnp.asarray(t), r, chunk=256)),
    )
    idx = rng.integers(0, 700, size=(300, 5))
    np.testing.assert_array_equal(np_(tneighbors.gather_knn(to_torch(t), to_torch(idx))),
                                  np_(jneighbors.gather_knn(jnp.asarray(t), jnp.asarray(idx))))


@pytest.mark.parametrize("k", [12, 20])
def test_knn_normals_match(k):
    """Within 1e-4 wherever the normal is defined to f32 precision: the two
    smallest eigenvalues of the neighbourhood covariance more than 1e-2 of
    the largest apart. Elsewhere (0.3 % of this scan's points, gaps of
    1.4e-3 to 2.5e-3) JAX's f32 solve and the port's float64 one differ by
    up to 1.5e-3."""
    j = _scan()
    jn = jnormals.estimate_normals(j, k=k)
    tn = tnormals.estimate_normals(torch_cloud(j), k=k)
    np.testing.assert_array_equal(np_(tn.xyz), np_(jn.xyz))
    np.testing.assert_array_equal(np_(tn.mask), np_(jn.mask))
    lam = np.linalg.eigvalsh(np_(tnormals.knn_covariance(to_torch(j.xyz), to_torch(j.mask), k)).astype(np.float64))
    defined = np_(j.mask) & (lam[:, 1] - lam[:, 0] > 1e-2 * lam[:, 2])
    assert defined.sum() > 0.9 * np_(j.mask).sum()
    np.testing.assert_allclose(np_(tn.normals)[defined], np_(jn.normals)[defined], atol=1e-4, rtol=0)


@pytest.mark.parametrize("knn,std", [(10, 1.0), (6, 0.5)])
def test_statistical_outlier_matches(knn, std):
    j = _scan()
    jo = jfilters.statistical_outlier(j, knn, std)
    to = tfilters.statistical_outlier(torch_cloud(j), knn, std)
    np.testing.assert_array_equal(np_(to.mask), np_(jo.mask))
    assert 0 < np_(j.mask).sum() - np_(to.mask).sum() < 0.5 * np_(j.mask).sum()


@pytest.mark.parametrize("radius,min_nb", [(0.15, 3), (0.5, 5)])
def test_radius_outlier_matches(radius, min_nb):
    j = _scan()
    jo = jfilters.radius_outlier(j, radius, min_nb)
    to = tfilters.radius_outlier(torch_cloud(j), radius, min_nb)
    np.testing.assert_array_equal(np_(to.mask), np_(jo.mask))
    assert np_(to.mask).sum() < np_(j.mask).sum()


@pytest.mark.parametrize("field,negative", [("z", False), ("x", True), ("y", False)])
def test_passthrough_matches(field, negative):
    j = _scan()
    jo = jfilters.passthrough(j, field, -1.0, 2.5, negative)
    to = tfilters.passthrough(torch_cloud(j), field, -1.0, 2.5, negative)
    np.testing.assert_array_equal(np_(to.mask), np_(jo.mask))
    np.testing.assert_array_equal(np_(to.xyz), np_(jo.xyz))


def test_random_sample_statistics():
    """Not bitwise: the kept fraction within 4 sigma of the binomial; one
    seed, one draw; another seed, another draw."""
    n = 4096
    pc = torch_cloud(JPC.from_points(np.random.default_rng(0).uniform(size=(n, 3)).astype(np.float32), capacity=n))
    for pct in (0.9, 0.5, 0.93):
        kept = []
        for seed in range(8):
            g = torch.Generator()
            g.manual_seed(seed)
            kept.append(int(tfilters.random_sample(pc, g, pct).mask.sum()))
        sigma = np.sqrt(n * pct * (1 - pct))
        assert abs(np.mean(kept) - n * (1 - pct)) < 4 * sigma / np.sqrt(len(kept)), (pct, kept)
    a, b, c = (torch.Generator().manual_seed(s) for s in (3, 3, 4))
    ma, mb, mc = (tfilters.random_sample(pc, g, 0.5).mask for g in (a, b, c))
    assert torch.equal(ma, mb) and not torch.equal(ma, mc)


@pytest.mark.parametrize("mode", ["adaptive", "recompute"])
def test_gicp_covariances_match(mode):
    j = _scan(capacity=1024)
    jfn = jgicp.covariance_adaptive if mode == "adaptive" else jgicp.covariance_from_neighborhood
    tfn = tgicp.covariance_adaptive if mode == "adaptive" else tgicp.covariance_from_neighborhood
    jc = np_(jfn(j.xyz, j.mask, 20, 1e-3))
    tc = np_(tfn(to_torch(j.xyz), to_torch(j.mask), 20, 1e-3))
    m = np_(j.mask)
    np.testing.assert_allclose(tc[m], jc[m], atol=1e-5, rtol=0)


def test_inv3x3_matches():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(np_(tgicp.inv3x3(to_torch(A))), np_(jgicp.inv3x3(jnp.asarray(A))), rtol=1e-5, atol=1e-6)


def _cube(capacity=1024, step=0.1, **kw):
    xyz, nrm = synthetic.hollow_cube(step=step, **kw)
    return JPC.from_points(jnp.asarray(xyz), capacity=capacity, normals=jnp.asarray(nrm))


@pytest.mark.parametrize("case", ["adaptive", "recompute", "explicit", "adaptive_pallas"])
def test_gicp_covariance_modes_match(case):
    src = _cube(jitter=0.005, seed=3)
    T = jse3.make_transform(jse3.so3_exp(jnp.asarray([0.02, -0.03, 0.05])), jnp.asarray([0.04, -0.03, 0.02]))
    tgt = src.transform(T)
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = [0.03, -0.02, 0.01]
    mode = "normals" if case == "explicit" else case.split("_")[0]
    kw = {}
    if case == "explicit":
        cov = np_(jgicp.covariance_adaptive(src.xyz, src.mask, 10, 1e-3))
        kw = dict(source_cov=cov, target_cov=np_(jgicp.covariance_adaptive(tgt.xyz, tgt.mask, 10, 1e-3)))
    ctx = force_pallas() if case.endswith("pallas") else contextlib.nullcontext()
    with ctx:
        j = jgicp.gicp_register(src, tgt, jnp.asarray(guess), JRC(covariance_mode=mode),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    t = tgicp.gicp_register(torch_cloud(src), torch_cloud(tgt), to_torch(guess), TRC(covariance_mode=mode),
                            **{k: to_torch(v) for k, v in kw.items()})
    dt, dr = pose_diff(np_(t.transform), np_(j.transform))
    assert dt < 1e-4 and dr < 1e-4, (dt, dr)
    assert int(t.iterations) == int(j.iterations)
    assert int(t.num_correspondences) == int(j.num_correspondences)
