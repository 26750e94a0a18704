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
