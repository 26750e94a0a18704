"""Generalized-ICP on tensors (counterpart of
`locus_tpu/registration/gicp.py`), production disk-covariance path.

Objective: min_x sum_i r_i^T M_i r_i with M_i = (C2_j + R C1_i R^T)^{-1},
r_i = T(x) p_i - q_j. In the production mode ("normals") each covariance
is a plane disk I - (1-eps) n n^T built from the normals and no 3x3 matrix
is formed; the "recompute" and "adaptive" modes (and caller-supplied
covariances) carry (N,3,3) covariances from a k-NN PCA. Per outer
iteration the correspondences come from the radius-bounded 1-NN (kernel
B2 at SCAN_BT), then `inner_iterations` Gauss-Newton steps on the SE(3)
tangent with M and the pairs fixed.

On the card, everything of a disk-mode trip after the 1-NN kernel is one
launch of kernel B7 (`ops/kernels/gicp.py`, bit-equal to the plain trip
below); the plain trip runs on the CPU, inside `dispatch.no_kernels()`,
and for the covariances B7 does not take (3x3 matrices).

Loop control: the JAX package runs the outer loop as a `lax.while_loop`
on a device-side test and the final re-lookup under `lax.cond`. Here each
of the cfg.iterations possible trips and the re-lookup is an
`ops.graph.gate` on a device flag: eager, one host read a trip (the loop
ends at the first false one); inside a captured step, an IF node, so the
trips after convergence launch nothing. Either way the iteration count
equals JAX's and no NN pass is launched for nothing. A trip writes its
results in place into the loop state made before the loop.

Batching: source, target and guess may carry one leading batch dimension
(the batched replay), with the meaning vmap gives the JAX function.
The outer loop runs while any member is still iterating; a member that has
stopped keeps its carry (`torch.where`), so its iterations, transform and
fitness equal its single run. The re-lookup runs when any member needs it
and is selected per member. Each outer iteration launches the 1-NN kernel
once for all members (B3; B2 on the single path). The Gauss-Newton sums
are pairwise (`tree_sum`) and the small products written out
(`se3.matmul`), so that a member rounds exactly as its single run does.
The loop's trips are its slowest member's count: a batched call adds B
times them and its members' own counts to the program counters
`gicp.member_trips_run` and `gicp.member_trips_needed` of the enclosing
stage (`ops.graph.count`); the difference is the trips of members that
had stopped, the price of lockstep.

The "recompute" and "adaptive" modes and explicit covariances batch the
same way: each member's k-NN covariances come from the batched
`neighbors.knn`, and the rotated covariance sums are written out
elementwise (`se3.matmul`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from locus_tpu_torch.config import RegistrationConfig
from locus_tpu_torch.core.cloud import PointCloud, take_rows
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.ops import dispatch, graph
from locus_tpu_torch.ops.kernels import count_launch, gicp as trip_kernel
from locus_tpu_torch.ops.normals import eigh_sym3x3, knn_covariance, smallest_eigenvector_sym3x3
from locus_tpu_torch.ops.kernels.nn import (
    SCAN_BT,
    build_nn_target,
    chunk_boxes,
    nearest_bounded_pre,
    nearest_bounded_raw,
)
from locus_tpu_torch.utils.linalg import chol_solve, sum_last, tree_sum


class GICPResult(NamedTuple):
    transform: torch.Tensor        # (4,4) source->target transform (incl. guess)
    converged: torch.Tensor        # bool
    iterations: torch.Tensor       # int32 outer iterations used
    fitness: torch.Tensor          # mean squared corr distance at convergence
    correspondences: torch.Tensor  # (N,) int64 target index per source point
    corr_mask: torch.Tensor        # (N,) bool valid & gated correspondences
    num_correspondences: torch.Tensor  # int32


def covariance_from_normals(normals: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Plane-disk covariance from unit normals: eigenvalues (1, 1, eps)
    with eps along the normal, C = I - (1-eps) n n^T."""
    eye = torch.eye(3, dtype=normals.dtype, device=normals.device)
    return eye - (1.0 - epsilon) * (normals[..., :, None] * normals[..., None, :])


def covariance_adaptive(xyz: torch.Tensor, mask: torch.Tensor, k: int, epsilon: float) -> torch.Tensor:
    """Structure-adaptive covariance: the k-NN PCA eigenvalues normalised
    by the largest and floored at eps, so planes become disks (1,1,eps),
    edges sticks (1,eps,eps), and corners stay isotropic (the LOAM feature
    clouds' mode). V diag(lam) V^T is summed elementwise (`se3.matmul`),
    so a batch member rounds as its single call does."""
    eigvals, eigvecs = eigh_sym3x3(knn_covariance(xyz, mask, k))
    lam_max = torch.clamp(eigvals[..., 2], min=1e-12)
    lam_reg = torch.clamp(eigvals / lam_max[..., None], epsilon, 1.0)
    return se3.matmul(eigvecs * lam_reg[..., None, :], eigvecs.transpose(-1, -2))


def covariance_from_neighborhood(xyz: torch.Tensor, mask: torch.Tensor, k: int, epsilon: float) -> torch.Tensor:
    """The recompute mode (gicp.hpp:89-156): the disk covariance of the
    k-NN PCA normal, singular values regularised to (1, 1, eps)."""
    _, normal = smallest_eigenvector_sym3x3(knn_covariance(xyz, mask, k))
    return covariance_from_normals(normal, epsilon)


def inv3x3(A: torch.Tensor, ridge: float = 1e-6) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..,3,3) symmetric matrices."""
    comps = _inv_sym3(_sym3_from_mats(A), ridge)
    return torch.stack([comps[i] for i in (0, 1, 2, 1, 3, 4, 2, 4, 5)], dim=-1).unflatten(-1, (3, 3))


def _sym3_from_mats(C: torch.Tensor):
    """(...,3,3) -> the six components (m00, m01, m02, m11, m12, m22)."""
    return (C[..., 0, 0], C[..., 0, 1], C[..., 0, 2], C[..., 1, 1], C[..., 1, 2], C[..., 2, 2])


def _sym3_vec(M, vx, vy, vz):
    """M @ v for a symmetric M in components and a vector in components."""
    m00, m01, m02, m11, m12, m22 = M
    return (
        m00 * vx + m01 * vy + m02 * vz,
        m01 * vx + m11 * vy + m12 * vz,
        m02 * vx + m12 * vy + m22 * vz,
    )


def _sym3_two_disks(a: torch.Tensor, b: torch.Tensor, epsilon: float):
    """Components of (I - k a a^T) + (I - k b b^T), k = 1-eps: the sum of
    the rotated source disk and the target disk covariances."""
    k = 1.0 - epsilon
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return (
        2.0 - k * (ax * ax + bx * bx),
        -k * (ax * ay + bx * by),
        -k * (ax * az + bx * bz),
        2.0 - k * (ay * ay + by * by),
        -k * (ay * az + by * bz),
        2.0 - k * (az * az + bz * bz),
    )


def _inv_sym3(A, ridge: float = 1e-6):
    """Adjugate inverse of symmetric 3x3 in component form."""
    a, b, c, d, e, f = A
    a = a + ridge
    d = d + ridge
    f = f + ridge
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    return (
        co00 * inv_det, co01 * inv_det, co02 * inv_det,
        co11 * inv_det, co12 * inv_det, co22 * inv_det,
    )


def _gauss_newton_step_comps(p_cur, q, M, w, lm_lambda):
    """Component-form weighted GN step for min sum_i w_i r^T M r with
    r = exp(xi) p - q and J = [I | -skew(p)]. The 21 unique entries of
    H = sum J^T M J and the 6 of g are column sums of one (N, 27) stack."""
    return _gauss_newton_solve(_gauss_newton_sums(p_cur, q, M, w), lm_lambda)


def _gauss_newton_sums(p_cur, q, M, w):
    """The (..., 27) column sums of the step: M's 6 components, B = M
    skew(p) (9), C = P^T M P (6), M r (3) and p x M r (3)."""
    px, py, pz = p_cur[..., 0], p_cur[..., 1], p_cur[..., 2]
    rx = px - q[..., 0]
    ry = py - q[..., 1]
    rz = pz - q[..., 2]
    m00, m01, m02, m11, m12, m22 = (m * w for m in M)

    # B = M @ skew(p)
    b00 = m01 * pz - m02 * py
    b10 = m11 * pz - m12 * py
    b20 = m12 * pz - m22 * py
    b01 = -m00 * pz + m02 * px
    b11 = -m01 * pz + m12 * px
    b21 = -m02 * pz + m22 * px
    b02 = m00 * py - m01 * px
    b12 = m01 * py - m11 * px
    b22 = m02 * py - m12 * px

    # C = P^T M P = -skew(p) @ B
    c00 = -(-pz * b10 + py * b20)
    c01 = -(-pz * b11 + py * b21)
    c02 = -(-pz * b12 + py * b22)
    c11 = -(pz * b01 - px * b21)
    c12 = -(pz * b02 - px * b22)
    c22 = -(-py * b02 + px * b12)

    mr0 = m00 * rx + m01 * ry + m02 * rz
    mr1 = m01 * rx + m11 * ry + m12 * rz
    mr2 = m02 * rx + m12 * ry + m22 * rz
    gw0 = -pz * mr1 + py * mr2
    gw1 = pz * mr0 - px * mr2
    gw2 = -py * mr0 + px * mr1

    return tree_sum(torch.stack(
        [m00, m01, m02, m11, m12, m22,
         b00, b01, b02, b10, b11, b12, b20, b21, b22,
         c00, c01, c02, c11, c12, c22,
         mr0, mr1, mr2, gw0, gw1, gw2],
        dim=-1,
    ))


def _gauss_newton_solve(s, lm_lambda):
    """The step dx from the 27 sums: H and g assembled, a trace ridge,
    the float64 Cholesky solve of H dx = -g."""
    H_tt = s[..., graph.constant((0, 1, 2, 1, 3, 4, 2, 4, 5), torch.int64, s.device)].unflatten(-1, (3, 3))
    H_tw = -s[..., 6:15].unflatten(-1, (3, 3))
    H_ww = s[..., graph.constant((15, 16, 17, 16, 18, 19, 17, 19, 20), torch.int64, s.device)].unflatten(-1, (3, 3))
    g = s[..., 21:27]
    H = torch.cat(
        [torch.cat([H_tt, H_tw], dim=-1), torch.cat([H_tw.transpose(-1, -2), H_ww], dim=-1)], dim=-2
    )
    trace = sum_last(torch.diagonal(H, dim1=-2, dim2=-1))
    ridge = lm_lambda * torch.clamp(trace / 6.0, min=1.0) * 1e-6
    H = H + torch.eye(6, dtype=H.dtype, device=H.device) * ridge[..., None, None]
    return -chol_solve(H, g)


def _scaled_delta(T_prev: torch.Tensor, T_new: torch.Tensor, cfg: RegistrationConfig):
    """Reference convergence metric (gicp.hpp:526-541): elementwise |dT|
    scaled by 1/rotation_epsilon on the 3x3 block and 1/tf_epsilon
    elsewhere; converged when the max < 1."""
    diff = torch.abs(T_prev - T_new)
    scale = torch.full((4, 4), 1.0 / cfg.tf_epsilon, dtype=diff.dtype, device=diff.device)
    scale[:3, :3].fill_(1.0 / cfg.rotation_epsilon)
    return torch.amax(diff * scale, dim=(-2, -1))


def select(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per batch member: `new` where the member is still iterating
    (`active`, one flag per member), else its kept `old`."""
    return torch.where(active.reshape(active.shape + (1,) * (new.dim() - active.dim())), new, old)


def gicp_register(
    source: PointCloud,
    target: PointCloud,
    guess: Optional[torch.Tensor] = None,
    cfg: RegistrationConfig = RegistrationConfig(),
    source_cov: Optional[torch.Tensor] = None,
    target_cov: Optional[torch.Tensor] = None,
) -> GICPResult:
    """Align `source` to `target`; returns the source->target transform.
    The guess pre-warps the source; the iterated transform starts at
    identity and the result is T_iter @ guess. With a leading batch
    dimension on the clouds (and the guess), each member is aligned as its
    own single call would align it."""
    mode = cfg.covariance_mode
    if cfg.recompute_covariances and mode == "normals":
        mode = "recompute"
    # the production path keeps only the normals and builds M on the fly
    disk_path = mode == "normals" and source_cov is None and target_cov is None

    def make_cov(cloud):
        if mode == "recompute":
            return covariance_from_neighborhood(cloud.xyz, cloud.mask, cfg.k_correspondences, cfg.gicp_epsilon)
        if mode == "adaptive":
            return covariance_adaptive(cloud.xyz, cloud.mask, cfg.k_correspondences, cfg.gicp_epsilon)
        return covariance_from_normals(cloud.normals, cfg.gicp_epsilon)

    if not disk_path:
        source_cov = make_cov(source) if source_cov is None else source_cov
        target_cov = make_cov(target) if target_cov is None else target_cov
    dev = source.xyz.device
    lead = source.mask.shape[:-1]
    if guess is None:
        guess = se3.identity(dev)

    src0 = se3.transform_points(guess, source.xyz)
    src0 = torch.where(source.mask[..., None], src0, source.xyz)  # keep sentinels
    src0_normals = se3.rotate_vectors(guess, source.normals)
    corr_dist2 = cfg.corr_dist * cfg.corr_dist

    # The target is loop-invariant: build its operand and chunk boxes once.
    t_aug = build_nn_target(target.xyz, bt=SCAN_BT)
    c_min, c_max = chunk_boxes(target.xyz, target.mask, t_aug.shape[-2], bt=SCAN_BT)

    def nearest_fn(p):
        d2, j = nearest_bounded_pre(
            p, t_aug, target.xyz, c_min, c_max, float(cfg.corr_dist), bt=SCAN_BT
        )
        return torch.where(torch.isfinite(d2), d2, 1e12), j

    # The loop state: buffers made once, written in place by every trip
    # (`graph.assign`), so that a trip can be a gated body.
    n_src = source.capacity
    T = se3.identity(dev).expand(lead + (4, 4)).clone()
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    delta = torch.full(lead, float("inf"), device=dev)
    fitness = torch.full(lead, float("inf"), device=dev)
    ncorr = torch.zeros(lead, dtype=torch.int32, device=dev)
    j_fin = torch.zeros(lead + (n_src,), dtype=torch.int64, device=dev)
    d2_fin = torch.full(lead + (n_src,), float("inf"), device=dev)
    go = torch.full((), cfg.iterations > 0, dtype=torch.bool, device=dev)   # a member still iterates

    # On the card a trip after its 1-NN is one launch of kernel B7 where it
    # takes the covariances (the disks); `trip` below is its plain version.
    on_card = source.xyz.is_cuda and dispatch.kernels_enabled()
    fused = on_card and disk_path
    if fused:
        kernel_source = (src0, src0_normals.contiguous(), source.mask.contiguous())
        kernel_target = tuple(x.contiguous() for x in (target.xyz, target.normals, target.mask))

    def kernel_trip():
        p = se3.transform_points(T, src0)
        _, i = nearest_bounded_raw(p, t_aug, c_min, c_max, float(cfg.corr_dist), bt=SCAN_BT)
        trip_kernel.gicp_trip(p, i, kernel_source, kernel_target, (T, it, delta, fitness, ncorr, j_fin, d2_fin, go), cfg)

    def trip():
        if on_card:
            count_launch("gicp_plain_trips")
        active = (it < cfg.iterations) & (delta >= 1.0)
        p = se3.transform_points(T, src0)
        d2, j = nearest_fn(p)
        w = (source.mask & take_rows(target.mask, j) & (d2 <= corr_dist2)).to(torch.float32)
        q = take_rows(target.xyz, j)
        if disk_path:
            # A = C2 + R C1 R^T = (I - k m m^T) + (I - k (Rn)(Rn)^T)
            A = _sym3_two_disks(
                se3.rotate_vectors(T, src0_normals), take_rows(target.normals, j), cfg.gicp_epsilon
            )
        else:
            # as in the JAX function: the source's own covariances (not
            # pre-warped by the guess), rotated by the iterated transform
            R = se3.rotation(T)[..., None, :, :]
            rotated = se3.matmul(se3.matmul(R, source_cov), R.transpose(-1, -2))
            A = _sym3_from_mats(take_rows(target_cov.flatten(-2), j).unflatten(-1, (3, 3)) + rotated)
        M = _inv_sym3(A)
        T_new = T
        for _ in range(cfg.inner_iterations):
            p_cur = se3.transform_points(T_new, src0)
            p_cur = torch.where(source.mask[..., None], p_cur, q)  # zero-residual pads
            dx = _gauss_newton_step_comps(p_cur, q, M, w, cfg.levenberg_lambda)
            T_new = se3.compose(se3.se3_exp(dx), T_new)
        T_new = se3.make_transform(se3.orthonormalize(se3.rotation(T_new)), se3.translation(T_new))
        wsum = tree_sum(w, dim=-1)
        new_delta = select(active, _scaled_delta(T, T_new, cfg), delta)
        new_it = it + active.to(torch.int32)
        graph.assign(fitness, select(active, tree_sum(d2 * w, dim=-1) / torch.clamp(wsum, min=1.0), fitness))
        graph.assign(ncorr, select(active, wsum.to(torch.int32), ncorr))
        graph.assign(j_fin, select(active, j, j_fin))
        graph.assign(d2_fin, select(active, d2, d2_fin))
        graph.assign(T, select(active, T_new, T))
        graph.assign(delta, new_delta)
        graph.assign(it, new_it)
        graph.assign(go, torch.any((new_it < cfg.iterations) & (new_delta >= 1.0)))

    # JAX's lax.while_loop: at most cfg.iterations trips, each gated on the
    # flag the previous one left (eager: one host read a trip, and the loop
    # ends at the first false; captured: trips after convergence launch
    # nothing). `it` counts the trips that ran; batched, the slowest
    # member's count (`loops`, written after the loop) does.
    loops = torch.zeros((), dtype=torch.int32, device=dev) if lead else it
    for _ in range(cfg.iterations):
        if not graph.gate(go, kernel_trip if fused else trip, trips=loops):
            break
    if lead:
        loops.copy_(it.amax())
        graph.count("gicp.member_trips_run", loops * lead.numel())
        graph.count("gicp.member_trips_needed", it.sum())

    converged = delta < 1.0
    # Exited on the iteration cap: the carried pairs may be stale, so
    # re-search at the final pose (PointCloudLocalization.cc:327-336);
    # JAX's lax.cond.
    if cfg.final_correspondence_relookup:
        relook = ~converged

        def relookup():
            p_fin = se3.transform_points(T, src0)
            p_fin = torch.where(source.mask[..., None], p_fin, src0)
            d2_r, j_r = nearest_fn(p_fin)
            graph.assign(d2_fin, select(relook, d2_r, d2_fin))
            graph.assign(j_fin, select(relook, j_r, j_fin))

        any_relook = torch.any(relook)
        graph.gate(any_relook, relookup, trips=any_relook)
    corr_mask = source.mask & take_rows(target.mask, j_fin) & (d2_fin <= corr_dist2)
    return GICPResult(
        transform=se3.compose(T, guess),
        converged=converged,
        iterations=it,
        fitness=fitness,
        correspondences=j_fin,
        corr_mask=corr_mask,
        num_correspondences=ncorr,
    )
