"""Scan-to-scan lidar odometry (counterpart of `locus_tpu/odometry.py`):
register scan k against scan k-1 with an optional motion prior, keep the
incremental and integrated estimates, gate divergent transforms, and
optionally project onto flat ground. `update` also takes a state and scan
with one leading batch dimension (the batched replay)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from locus_tpu_torch.config import RegistrationConfig
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.ops import graph
from locus_tpu_torch.ops.dispatch import resolve_device
from locus_tpu_torch.registration.gicp import GICPResult
from locus_tpu_torch.registration.registry import make_registrar


class OdometryState(NamedTuple):
    initialized: torch.Tensor          # bool — first scan consumed?
    reference: PointCloud              # scan k-1 (registration target)
    incremental: torch.Tensor          # (4,4) last scan-to-scan delta
    integrated: torch.Tensor           # (4,4) odometry pose
    is_healthy: torch.Tensor           # bool


class OdometryUpdate(NamedTuple):
    state: OdometryState
    performed: torch.Tensor            # bool — False on the first scan
    accepted: torch.Tensor             # bool — delta passed gating
    icp: GICPResult


def init_state(capacity: int, initial_pose: Optional[torch.Tensor] = None, device=None) -> OdometryState:
    """`initial_pose` seeds the integrated estimate (the reference's
    fiducial-calibration init). `device=None` means the CUDA device."""
    device = resolve_device(device)
    pose = se3.identity(device) if initial_pose is None else initial_pose.to(device, torch.float32)
    return OdometryState(
        initialized=torch.tensor(False, device=device),
        reference=PointCloud.empty(capacity, device=device),
        incremental=se3.identity(device),
        integrated=pose.clone(),
        is_healthy=torch.tensor(True, device=device),
    )


def gate(T: torch.Tensor, cfg: RegistrationConfig) -> torch.Tensor:
    """Reference transform-delta gating (PointCloudOdometry.cc:305-316):
    reject if ||t|| > max_translation or ||euler_zyx|| > max_rotation."""
    if not cfg.transform_thresholding:
        return torch.ones(T.shape[:-2], dtype=torch.bool, device=T.device)
    r, p, y = se3.matrix_to_euler_zyx(se3.rotation(T))
    r_norm = torch.sqrt(r * r + p * p + y * y)
    return (se3.translation_norm(T) <= cfg.max_translation) & (r_norm <= cfg.max_rotation)


def project_flat_ground(T: torch.Tensor) -> torch.Tensor:
    """Flat-ground projection (PointCloudOdometry.cc:277-291): zero z and
    keep yaw only."""
    R = se3.yaw_only_matrix(se3.rotation(T))
    t = se3.translation(T) * graph.constant((1.0, 1.0, 0.0), torch.float32, T.device)
    return se3.make_transform(R, t)


def update(
    state: OdometryState,
    scan: PointCloud,
    prior: Optional[torch.Tensor] = None,
    cfg: RegistrationConfig = RegistrationConfig(),
    flat_ground: bool = False,
) -> OdometryUpdate:
    """Consume one scan; `prior` (4x4, identity or None for pure LO) is the
    GICP guess (PointCloudOdometry.cc:252-276)."""
    dev = scan.xyz.device
    guess = prior if prior is not None else se3.identity(dev)
    icp = make_registrar(cfg)(scan, state.reference, guess=guess)
    T = project_flat_ground(icp.transform) if flat_ground else icp.transform
    accepted = gate(T, cfg)

    # On the very first scan there is no reference yet: do not move.
    performed = state.initialized
    use = (performed & accepted)[..., None, None]
    incremental = torch.where(
        use, T, torch.where(performed[..., None, None], state.incremental, se3.identity(dev))
    )
    integrated = torch.where(use, se3.compose(state.integrated, T), state.integrated)
    integrated = se3.make_transform(
        se3.orthonormalize(se3.rotation(integrated)), se3.translation(integrated)
    )
    new_state = OdometryState(
        initialized=torch.ones_like(state.initialized),
        reference=scan,
        incremental=incremental,
        integrated=integrated,
        is_healthy=torch.ones_like(state.is_healthy),
    )
    return OdometryUpdate(new_state, performed, accepted, icp)

