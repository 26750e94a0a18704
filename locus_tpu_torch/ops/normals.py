"""Per-point normal estimation by local PCA (counterpart of
`locus_tpu/ops/normals.py`).

Two paths: fixed-radius neighbourhood moments from kernel B1
(`ops/kernels/moments.py`, `estimate_normals_radius`, the default) and the
k nearest neighbours of `ops/neighbors.knn` (`estimate_normals`, plain
PyTorch as the JAX package's is XLA; the LOAM feature path and the
ground-truth map use it). A closed-form symmetric 3x3 eigendecomposition
gives the normal.
"""
from __future__ import annotations

import math

import torch

from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.ops import neighbors

_EPS = 1e-12


def _trig_eigvals(a00, a01, a02, a11, a12, a22):
    """Analytic eigenvalues (Smith's method) of a symmetric 3x3 in
    component form: (q, p1, lam_hi, lam_mid, lam_lo)."""
    tr = a00 + a11 + a22
    q = tr / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (p * p * p)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = tr - lam_hi - lam_lo
    return p1, lam_hi, lam_mid, lam_lo


def smallest_eigenvector_sym3x3_comps(a00, a01, a02, a11, a12, a22):
    """Batched symmetric-3x3 smallest eigenpair on six (N,) component
    tensors. Returns (lam3, vx, vy, vz)."""
    p1, lam1, lam2, lam3 = _trig_eigvals(a00, a01, a02, a11, a12, a22)
    # v3 spans the column space of M = (A - lam1 I)(A - lam2 I), a
    # symmetric polynomial in A: six components suffice.
    d01, d02 = a00 - lam1, a00 - lam2
    e01, e02 = a11 - lam1, a11 - lam2
    f01, f02 = a22 - lam1, a22 - lam2
    m00 = d01 * d02 + a01 * a01 + a02 * a02
    m01 = d01 * a01 + a01 * e02 + a02 * a12
    m02 = d01 * a02 + a01 * a12 + a02 * f02
    m11 = a01 * a01 + e01 * e02 + a12 * a12
    m12 = a01 * a02 + e01 * a12 + a12 * f02
    m22 = a02 * a02 + a12 * a12 + f01 * f02

    n0 = m00 * m00 + m01 * m01 + m02 * m02   # squared column norms
    n1 = m01 * m01 + m11 * m11 + m12 * m12
    n2 = m02 * m02 + m12 * m12 + m22 * m22
    use1 = (n1 >= n0) & (n1 >= n2)
    use2 = (n2 > n0) & (n2 > n1)
    vx = torch.where(use2, m02, torch.where(use1, m01, m00))
    vy = torch.where(use2, m12, torch.where(use1, m11, m01))
    vz = torch.where(use2, m22, torch.where(use1, m12, m02))
    vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    degenerate = (vn < 1e-10) | (p1 < _EPS)
    inv = 1.0 / torch.clamp(vn, min=_EPS)
    vx = torch.where(degenerate, 0.0, vx * inv)
    vy = torch.where(degenerate, 0.0, vy * inv)
    vz = torch.where(degenerate, 1.0, vz * inv)
    return lam3, vx, vy, vz


def smallest_eigenvector_sym3x3(A: torch.Tensor):
    """Batched (..,3,3) symmetric -> (smallest eigenvalue, eigenvector)."""
    lam3, vx, vy, vz = smallest_eigenvector_sym3x3_comps(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )
    return lam3, torch.stack([vx, vy, vz], dim=-1)


def eigh_sym3x3(A: torch.Tensor):
    """Full batched symmetric 3x3 eigendecomposition (analytic). Returns
    (eigvals (..,3) ascending, eigvecs (..,3,3) columns matching)."""
    _, lam_hi, lam_mid, lam_lo = _trig_eigvals(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device)
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=A.dtype, device=A.device)

    def vec_for(l_other1, l_other2):
        M = (A - l_other1[..., None, None] * eye) @ (A - l_other2[..., None, None] * eye)
        norms = torch.linalg.norm(M, dim=-2)
        col = torch.argmax(norms, dim=-1)
        v = torch.gather(M, -1, col[..., None, None].expand(col.shape + (3, 1)))[..., 0]
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return torch.where(n < 1e-10, e_x.expand(v.shape), v / torch.clamp(n, min=_EPS))

    v_lo = vec_for(lam_hi, lam_mid)
    v_hi = vec_for(lam_lo, lam_mid)
    # repeated eigenvalues: v_hi ~ v_lo, rebuild an orthogonal frame
    parallel = torch.abs(torch.sum(v_hi * v_lo, dim=-1)) > 0.9
    alt = torch.where(torch.abs(v_lo[..., :1]) < 0.9, e_x.expand(v_lo.shape), e_y.expand(v_lo.shape))
    v_hi_fix = torch.linalg.cross(v_lo, alt, dim=-1)
    v_hi_fix = v_hi_fix / torch.clamp(torch.linalg.norm(v_hi_fix, dim=-1, keepdim=True), min=_EPS)
    v_hi = torch.where(parallel[..., None], v_hi_fix, v_hi)
    v_mid = torch.linalg.cross(v_hi, v_lo, dim=-1)
    v_mid = v_mid / torch.clamp(torch.linalg.norm(v_mid, dim=-1, keepdim=True), min=_EPS)
    eigvals = torch.stack([lam_lo, lam_mid, lam_hi], dim=-1)
    eigvecs = torch.stack([v_lo, v_mid, v_hi], dim=-1)
    return eigvals, eigvecs


def estimate_normals_radius(
    cloud: PointCloud,
    radius,
    viewpoint=(0.0, 0.0, 0.0),
    min_neighbors: int = 4,
) -> PointCloud:
    """Fixed-radius PCA normals from one box-pruned moments pass (kernel
    B1). `radius` may be a 0-d tensor tied to the adaptive voxel leaf.
    Points with fewer than `min_neighbors` in range get a zero normal.
    A batched cloud (B, N) takes a (B,) radius, one per member, and runs
    kernel B4 once for all members."""
    from locus_tpu_torch.ops.kernels.moments import radius_moments_pruned_comps

    count, _, cov_c = radius_moments_pruned_comps(cloud.xyz, cloud.xyz, radius)
    # The eigenvector is solved in float64: for thin neighbourhoods (4-5
    # points, variances ~1e-6 m^2) f32 rounding in the solve alone turns
    # normals by degrees. XLA may fuse the JAX package's f32 solve into
    # multiply-adds, which keeps it nearer the float64 answer than plain
    # f32 arithmetic; float64 here tracks it best on the golden replay.
    _, vx, vy, vz = (c.float() for c in smallest_eigenvector_sym3x3_comps(*(c.double() for c in cov_c)))
    vp = torch.as_tensor(viewpoint, dtype=torch.float32, device=cloud.xyz.device)
    dot = (
        vx * (vp[0] - cloud.xyz[..., 0])
        + vy * (vp[1] - cloud.xyz[..., 1])
        + vz * (vp[2] - cloud.xyz[..., 2])
    )
    sign = torch.where(dot < 0.0, -1.0, 1.0)
    ok = cloud.mask & (count >= float(min_neighbors))
    s = torch.where(ok, sign, 0.0)
    normal = torch.stack([vx * s, vy * s, vz * s], dim=-1)
    return PointCloud(cloud.xyz, normal, cloud.intensity, cloud.mask)


def knn_covariance(xyz: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """(N,3,3) covariance of each point's k nearest valid neighbours
    (itself included), the shared first half of the kNN normals and the
    GICP `recompute`/`adaptive` covariances."""
    _, idx = neighbors.knn(xyz, xyz, k=k)
    nbr = neighbors.gather_knn(xyz, idx)                 # (N, k, 3)
    nbr_mask = mask[idx]
    w = nbr_mask.to(torch.float32)
    denom = torch.clamp(torch.sum(w, dim=1), min=1.0)
    nbr_safe = torch.where(nbr_mask[..., None], nbr, 0.0)
    mean = torch.sum(nbr_safe * w[..., None], dim=1) / denom[:, None]
    centered = torch.where(nbr_mask[..., None], nbr - mean[:, None, :], 0.0)
    return torch.einsum("nki,nkj->nij", centered, centered) / denom[:, None, None]


def estimate_normals(cloud: PointCloud, k: int = 20, viewpoint=(0.0, 0.0, 0.0)) -> PointCloud:
    """PCA normals from the k nearest neighbours, oriented toward
    `viewpoint` (PCL flips normals so n . (vp - p) >= 0). The eigenvector
    is solved in float64, as in `estimate_normals_radius`."""
    cov = knn_covariance(cloud.xyz, cloud.mask, k)
    _, normal = smallest_eigenvector_sym3x3(cov.double())
    normal = normal.float()
    vp = torch.as_tensor(viewpoint, dtype=torch.float32, device=cloud.xyz.device)
    flip = torch.sum(normal * (vp - cloud.xyz), dim=-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    normal = torch.where(cloud.mask[:, None], normal, 0.0)
    return PointCloud(cloud.xyz, normal, cloud.intensity, cloud.mask)
