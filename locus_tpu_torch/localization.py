"""Scan-to-submap localization with ICP covariance and observability
(counterpart of `locus_tpu/localization.py`; reference
PointCloudLocalization.cc).

Ap = sum_i H_i^T H_i with H_i = [a_i x n_i, n_i], a_i from the normalized
query (centroid at origin, mean radius 1) and n_i the correspondent's
normal. One 6x6 Jacobi eigendecomposition of Ap gives the covariance
0.05^2 Ap^-1 (spectrum clamped), its condition number and the
observability spectrum.

`measurement_update` also takes a state, query and reference with one
leading batch dimension (the batched replay).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from locus_tpu_torch.config import LocalizationConfig
from locus_tpu_torch.core.cloud import PointCloud, take_rows
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.odometry import gate, project_flat_ground
from locus_tpu_torch.ops.dispatch import resolve_device
from locus_tpu_torch.registration.gicp import GICPResult
from locus_tpu_torch.registration.registry import make_registrar
from locus_tpu_torch.ops.kernels.eigh import eigh6


class LocalizationState(NamedTuple):
    incremental: torch.Tensor     # (4,4) current scan-to-scan increment
    integrated: torch.Tensor      # (4,4) world pose
    covariance: torch.Tensor      # (6,6) latest delta covariance
    condition_number: torch.Tensor
    observability_eigenvalues: torch.Tensor   # (6,)
    observability_matrix: torch.Tensor        # (6,6) Ap
    is_healthy: torch.Tensor


class MeasurementResult(NamedTuple):
    state: LocalizationState
    accepted: torch.Tensor
    icp: GICPResult


def init_state(initial_pose: Optional[torch.Tensor] = None, device=None) -> LocalizationState:
    """`device=None` means the CUDA device."""
    device = resolve_device(device)
    pose = se3.identity(device) if initial_pose is None else initial_pose.to(device, torch.float32)
    f32 = dict(dtype=torch.float32, device=device)
    return LocalizationState(
        incremental=se3.identity(device),
        integrated=pose.clone(),
        covariance=torch.zeros((6, 6), **f32),
        condition_number=torch.tensor(0.0, **f32),
        observability_eigenvalues=torch.zeros((6,), **f32),
        observability_matrix=torch.zeros((6, 6), **f32),
        is_healthy=torch.tensor(True, device=device),
    )


def motion_update(state: LocalizationState, incremental: torch.Tensor) -> LocalizationState:
    """Store the odometry increment (.cc:174-179)."""
    return state._replace(incremental=incremental)


def predicted_pose(state: LocalizationState) -> torch.Tensor:
    """integrated o incremental — the prediction used for both frame
    transforms (.cc:181-221)."""
    return se3.compose(state.integrated, state.incremental)


def transform_points_to_fixed_frame(state: LocalizationState, cloud: PointCloud) -> PointCloud:
    return cloud.transform(predicted_pose(state))


def transform_points_to_sensor_frame(state: LocalizationState, cloud: PointCloud) -> PointCloud:
    return cloud.transform(se3.inverse(predicted_pose(state)))


def set_integrated_estimate(state: LocalizationState, pose) -> LocalizationState:
    """External pose reset hook for a loop-closure backend
    (PointCloudLocalization.h:114-117)."""
    dev = state.integrated.device
    return state._replace(integrated=torch.as_tensor(pose, dtype=torch.float32).to(dev).clone())


def normalize_cloud_points(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """normalizePCloud (utils.cc): center at the centroid and scale so the
    mean distance to the origin is 1."""
    denom = torch.clamp(torch.sum(mask.to(torch.float32), dim=-1), min=1.0)[..., None]
    centroid = torch.sum(torch.where(mask[..., None], xyz, 0.0), dim=-2) / denom
    centered = xyz - centroid[..., None, :]
    dist = torch.sum(torch.where(mask, se3.norm(centered), 0.0), dim=-1, keepdim=True) / denom
    return centered * (1.0 / torch.clamp(dist, min=1e-12))[..., None]


def compute_ap_point2plane(query_xyz, query_mask, reference_normals, correspondences, corr_mask):
    """Ap = sum_i H_i^T H_i, H_i = [a_i x n_i, n_i] over valid pairs
    (.cc:725-750, second overload)."""
    a = normalize_cloud_points(query_xyz, query_mask)
    n = take_rows(reference_normals, correspondences)
    w = (query_mask & corr_mask).to(torch.float32)
    H = torch.cat([torch.linalg.cross(a, n, dim=-1), n], dim=-1)   # (...,N,6)
    return (H * w[..., None]).transpose(-1, -2) @ H


def covariance_from_ap_eig(ap_eigval, ap_eigvec, icp_max_covariance: float):
    """cov = 0.05^2 Ap^-1 from the eigendecomposition of Ap, eigenvalues
    clamped to [1e-12, icp_max_covariance] (.cc:469-541); returns
    (cov, condition number)."""
    lam = ap_eigval + 1e-9
    cov_eig = 0.05 * 0.05 / torch.where(torch.abs(lam) < 1e-30, 1e-30, lam)
    clamped = torch.clamp(cov_eig, 1e-12, icp_max_covariance)
    cov_c = (ap_eigvec * clamped[..., None, :]) @ ap_eigvec.transpose(-1, -2)
    bad = torch.any(torch.isnan(cov_c).flatten(-2), dim=-1)
    eye = torch.eye(6, dtype=ap_eigvec.dtype, device=ap_eigvec.device)
    cov_c = torch.where(bad[..., None, None], eye * icp_max_covariance, cov_c)
    condition_number = torch.amax(clamped, dim=-1) / torch.clamp(torch.amin(clamped, dim=-1), min=1e-30)
    return cov_c, condition_number


def point2plane_covariance(Ap: torch.Tensor, icp_max_covariance: float):
    """cov = 0.05^2 Ap^-1, eigenvalues clamped to [1e-12,
    icp_max_covariance], and the condition number of the clamped spectrum
    (.cc:469-541), from one Jacobi eigendecomposition of Ap (B8 on the
    card)."""
    eigval, eigvec = eigh6(Ap)
    return covariance_from_ap_eig(eigval, eigvec, icp_max_covariance)


def compute_observability(Ap: torch.Tensor):
    """Eigendecomposition of Ap (.cc:439-467): (eigenvalues ascending,
    eigenvectors as columns): `utils/linalg.py::jacobi_eigh` of its
    symmetric part, one B8 launch on the card."""
    return eigh6(Ap)


def measurement_update(
    state: LocalizationState,
    query: PointCloud,
    reference: PointCloud,
    cfg: LocalizationConfig = LocalizationConfig(),
    flat_ground: bool = False,
) -> MeasurementResult:
    """Align `query` (sensor frame) to `reference` (submap neighbours in
    the sensor frame) and fold the correction into the pose (.cc:291-427)."""
    if cfg.compute_icp_covariance and cfg.icp_covariance_method != 1:
        raise ValueError(
            f"icp_covariance_method={cfg.icp_covariance_method} is not "
            "supported: only 1 (point-to-plane) exists — the reference "
            "removed method 0 (point-to-point)"
        )
    rcfg = cfg.registration
    icp = make_registrar(rcfg)(query, reference)
    T = project_flat_ground(icp.transform) if flat_ground else icp.transform
    accepted = gate(T, rcfg)
    incremental = torch.where(
        accepted[..., None, None], se3.compose(state.incremental, T), state.incremental
    )
    integrated = se3.compose(state.integrated, incremental)
    integrated = se3.make_transform(
        se3.orthonormalize(se3.rotation(integrated)), se3.translation(integrated)
    )

    # Ap, its eigendecomposition and the covariance run in float64 and are
    # rounded to f32 once: a batched product over the N points sums in
    # another order than a single one, and float64 keeps that difference
    # below the f32 rounding, so a batch member gets its single results.
    if cfg.compute_icp_covariance or cfg.compute_icp_observability:
        Ap = compute_ap_point2plane(
            query.xyz.double(), query.mask, reference.normals.double(), icp.correspondences, icp.corr_mask
        )
        ap_eigval, ap_eigvec = compute_observability(Ap)
    else:
        Ap = torch.zeros(query.mask.shape[:-1] + (6, 6), dtype=torch.float64, device=query.xyz.device)
    if cfg.compute_icp_covariance:
        cov, cond = (x.float() for x in covariance_from_ap_eig(ap_eigval, ap_eigvec, cfg.icp_max_covariance))
    else:
        cov, cond = state.covariance, state.condition_number
    obs = ap_eigval.float() if cfg.compute_icp_observability else state.observability_eigenvalues

    new_state = LocalizationState(
        incremental=incremental,
        integrated=integrated,
        covariance=cov,
        condition_number=cond,
        observability_eigenvalues=obs,
        observability_matrix=Ap.float(),
        is_healthy=torch.ones_like(state.is_healthy),
    )
    return MeasurementResult(new_state, accepted, icp)
