"""Pose-graph optimisation: batched Gauss-Newton on SE(3) (counterpart of
the unsharded part of `locus_tpu/parallel/posegraph.py`).

The reference exposes `SetIntegratedEstimate` so that an external SLAM
backend can overwrite the pose after a loop closure
(PointCloudLocalization.h:114-117) but holds no solver; this is one.

- nodes: keyframe poses (B, 4, 4)
- factors: relative-pose measurements (i, j, T_ij, 6x6 information, mask)
- solver: Gauss-Newton on the residual r = log(T_ij^-1 T_i^-1 T_j) with
  Jacobians at identity for both endpoints; the normal equations are
  assembled per node and solved by preconditioned conjugate gradient,
  whose product with H is a gather, a per-factor product and a per-node
  sum, never H itself.

The iteration counts are fixed (the JAX package's `lax.scan`s), so a solve
reads nothing on the host. Per-node sums are products with a one-hot
(node, factor) matrix built once a solve: they sum in an order fixed by the
shapes on the CPU and the card alike, where a scatter-add would race on
the card. `optimize_sharded` (factors over a mesh) is ROADMAP A16.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from locus_tpu_torch.geometry import se3
from locus_tpu_torch.ops.dispatch import resolve_device


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (B,4,4) current estimates
    factor_i: torch.Tensor     # (F,) int64 from-node
    factor_j: torch.Tensor     # (F,) int64 to-node
    factor_T: torch.Tensor     # (F,4,4) measured T_i^-1 T_j
    factor_info: torch.Tensor  # (F,6,6) information matrices
    factor_mask: torch.Tensor  # (F,) bool
    anchor: int                # the gauge-fixed node


def make_graph(poses, factor_i, factor_j, factor_T, factor_info=None, factor_mask=None, anchor=0,
               device=None) -> PoseGraph:
    """A graph on `device` (None: the CUDA device) from array-likes; the
    information defaults to identity and every factor is on."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    fi = torch.as_tensor(factor_i).to(dev, torch.int64)
    F = fi.shape[0]
    info = torch.eye(6, device=dev).expand(F, 6, 6) if factor_info is None else f32(factor_info)
    mask = torch.ones(F, dtype=torch.bool, device=dev) if factor_mask is None else torch.as_tensor(factor_mask).to(dev, torch.bool)
    return PoseGraph(f32(poses), fi, torch.as_tensor(factor_j).to(dev, torch.int64), f32(factor_T),
                     info.contiguous(), mask, int(anchor))


def _residuals_and_jacobians(g: PoseGraph):
    """r_f = log(T_meas^-1 T_i^-1 T_j) (F,6) and the right-perturbation
    Jacobians at identity: J_j = I, J_i = -Ad(T_j^-1 T_i) (first order,
    standard for small inter-keyframe errors)."""
    Ti, Tj = g.poses[g.factor_i], g.poses[g.factor_j]
    Tij = se3.compose(se3.inverse(Ti), Tj)
    r = se3.se3_log(se3.compose(se3.inverse(g.factor_T), Tij))
    Tji = se3.inverse(Tij)
    R, t = se3.rotation(Tji), se3.translation(Tji)
    Ad = torch.cat([torch.cat([R, se3.matmul(se3.skew(t), R)], dim=-1),
                    torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)   # (F,6,6)
    Jj = torch.eye(6, dtype=r.dtype, device=r.device).expand(Ad.shape)
    return r, -Ad, Jj


def _node_sums(g: PoseGraph):
    """One-hot (B, F) matrices of the factors' from- and to-nodes."""
    nodes = torch.arange(g.poses.shape[0], device=g.poses.device)[:, None]
    return (g.factor_i[None] == nodes).to(torch.float32), (g.factor_j[None] == nodes).to(torch.float32)


def _weighted_info(g: PoseGraph) -> torch.Tensor:
    """Each factor's information, zero for the factors that are off."""
    return g.factor_info * g.factor_mask.to(torch.float32)[:, None, None]


def _assemble(r, Ji, Jj, Wi, Si, Sj):
    """Per-node gradient b (B,6) and block-diagonal preconditioner D
    (B,6,6)."""
    Wr = se3.matvec(Wi, r)
    gi = se3.matvec(Ji.transpose(-1, -2), Wr)
    gj = se3.matvec(Jj.transpose(-1, -2), Wr)
    b = Si @ gi + Sj @ gj
    Hii = se3.matmul(se3.matmul(Ji.transpose(-1, -2), Wi), Ji)
    Hjj = se3.matmul(se3.matmul(Jj.transpose(-1, -2), Wi), Jj)
    D = (Si @ Hii.flatten(-2) + Sj @ Hjj.flatten(-2)).unflatten(-1, (6, 6))
    return b, D


def _hvp(g: PoseGraph, Ji, Jj, Wi, Si, Sj, x):
    """H @ x without forming H: per-factor gather, apply, per-node sum."""
    u = se3.matvec(Ji, x[g.factor_i]) + se3.matvec(Jj, x[g.factor_j])
    Wu = se3.matvec(Wi, u)
    return Si @ se3.matvec(Ji.transpose(-1, -2), Wu) + Sj @ se3.matvec(Jj.transpose(-1, -2), Wu)


def _solve_pcg(g, Ji, Jj, Wi, Si, Sj, b, D, damping: float, iters: int):
    """Preconditioned CG on (H + damping I) dx = -b with the block-Jacobi
    preconditioner of D; the anchor's update is held at zero."""
    B = b.shape[0]
    eye = torch.eye(6, dtype=b.dtype, device=b.device)
    Dinv = torch.linalg.inv(D + (damping + 1e-6) * eye)
    keep = (torch.arange(B, device=b.device) != g.anchor)[:, None].to(b.dtype)

    def A(x):
        x = x * keep
        return (_hvp(g, Ji, Jj, Wi, Si, Sj, x) + damping * x) * keep

    def precond(x):
        return se3.matvec(Dinv, x) * keep

    rhs = -b * keep
    x = torch.zeros_like(rhs)
    r = rhs - A(x)
    z = precond(r)
    p = z
    for _ in range(iters):
        Ap = A(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z2 = precond(r)
        beta = torch.sum(r * z2) / torch.clamp(rz, min=1e-20)
        z = z2
        p = z + beta * p
    return x


def optimize(g: PoseGraph, iterations: int = 10, cg_iterations: int = 25, damping: float = 1e-4) -> PoseGraph:
    """`iterations` Gauss-Newton steps, each with `cg_iterations` PCG
    steps; right-multiplicative updates, rotations re-orthonormalised."""
    Si, Sj = _node_sums(g)
    Wi = _weighted_info(g)
    for _ in range(iterations):
        r, Ji, Jj = _residuals_and_jacobians(g)
        b, D = _assemble(r, Ji, Jj, Wi, Si, Sj)
        dx = _solve_pcg(g, Ji, Jj, Wi, Si, Sj, b, D, damping, cg_iterations)
        poses = se3.compose(g.poses, se3.se3_exp(dx))
        g = g._replace(poses=se3.make_transform(se3.orthonormalize(se3.rotation(poses)), se3.translation(poses)))
    return g


def graph_cost(g: PoseGraph) -> torch.Tensor:
    """sum_f r_f^T Info_f r_f over the factors that are on."""
    r, _, _ = _residuals_and_jacobians(g)
    return torch.sum(se3._dot(r, se3.matvec(g.factor_info, r)) * g.factor_mask.to(r.dtype))


def optimize_sharded(mesh, g: PoseGraph, iterations: int = 10, cg_iterations: int = 25,
                     damping: float = 1e-4, axis: str = "map") -> PoseGraph:
    raise NotImplementedError("posegraph.optimize_sharded: factors over a mesh are ROADMAP A16")
