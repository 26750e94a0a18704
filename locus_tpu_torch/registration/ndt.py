"""Normal Distributions Transform registration (counterpart of
`locus_tpu/registration/ndt.py`; the reference's pclomp NDT,
ndt_omp_impl.hpp and voxel_grid_covariance_omp_impl.hpp).

The target is voxelised at `ndt_resolution` into Gaussian components
(two-pass centred moments per voxel, ridge-floored, adjugate-inverted),
and every voxel's packed key goes into a direct-address hash table. A
source point scores against a fixed neighbourhood of voxels (DIRECT1, 7,
26, or the KDTREE gate), each one hashed gather. Two optimisers run on
that score (cfg.ndt_optimizer): "irls" reweights a Gauss-Newton step on
the Mahalanobis residuals by the Gaussian score; "newton" takes the
reference's Newton direction with a Moré–Thuente (or Armijo) line search,
warm-started by a few IRLS iterations. The last correspondence pass runs
kernel B2 at SCAN_BT against the raw target points.

Loop control, as in `registration/gicp.py`: the outer loop's test and each
Moré–Thuente trial's test are read on the host (one read per iteration
or trial), so iteration and trial counts equal JAX's.

Rounding differences from the JAX function (documented, not algorithmic):
the 6x6 Newton system is solved in float64 (JAX: an f32 LU), the
Gauss-Newton sums are pairwise (`tree_sum`), and the per-voxel segment
sums run in sorted-key order as XLA's CPU scatter-add does. The Newton
Hessian may be indefinite; its solution is flipped when it is not a
descent direction by the same exact rule (g . delta > 0).

Batching: source, target and guess may carry one leading batch dimension
(the batched replay), with the meaning vmap gives the JAX function. Each
member sorts its own keys and keeps its own hash table; the outer loop
runs while any member iterates and freezes the finished ones
(`torch.where`), and the Moré–Thuente search runs while any member's
search runs, each member taking exactly the trials its single call
takes. Every sum over points is pairwise (`tree_sum`), so a member
rounds as its single call does. The final pass runs kernel B3 once for
all members (B2 on the single path).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from locus_tpu_torch.config import RegistrationConfig
from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud, scatter_rows, take_rows
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.ops import neighbors
from locus_tpu_torch.ops.kernels.nn import SCAN_BT, build_nn_target, chunk_boxes, nearest_bounded_pre
from locus_tpu_torch.ops.voxel import _segment_offsets
from locus_tpu_torch.registration.gicp import (
    GICPResult,
    _gauss_newton_step_comps,
    _inv_sym3,
    _scaled_delta,
    _sym3_vec,
    select,
)
from locus_tpu_torch.registration.registry import register_method
from locus_tpu_torch.utils.linalg import sum_last, tree_sum

# Voxel-key packing: coordinates clipped to [-_KEY_B, _KEY_B - 1] pack into
# one non-negative int below 2^30; scenes beyond resolution * _KEY_B from
# the origin alias at the clip boundary, as in the JAX package.
_KEY_B = 512
_KEY_S = 1024
_KEY_PAD = (1 << 31) - 1   # INT32_MAX: padding rows and empty hash slots
_HASH_MUL = 2654435761
_MASK32 = 0xFFFFFFFF

_OFFSETS = {
    "direct1": [[0, 0, 0]],
    "direct7": [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    # DIRECT26 and the KDTREE gate gather the whole 3x3x3 block
    "direct26": [[i, j, k] for i in (0, -1, 1) for j in (0, -1, 1) for k in (0, -1, 1)],
}
_OFFSETS["kdtree"] = _OFFSETS["direct26"]


def _encode_keys(ijk: torch.Tensor) -> torch.Tensor:
    """(..., 3) integer voxel coordinates -> (...) int64 packed keys."""
    c = torch.clamp(ijk.to(torch.int64), -_KEY_B, _KEY_B - 1)
    return ((c[..., 0] + _KEY_B) * _KEY_S + (c[..., 1] + _KEY_B)) * _KEY_S + (c[..., 2] + _KEY_B)


def _hash_slot(keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """Multiplicative hash of packed keys into the direct-address table.
    JAX multiplies in uint32, which torch hardly supports: here the product
    is taken in int64 (keys < 2^31, so it stays below 2^63) and cut to its
    low 32 bits BEFORE the shift, which gives the uint32 product's bits."""
    h = ((keys.to(torch.int64) & _MASK32) * _HASH_MUL) & _MASK32
    return (h >> 15) % table_size


class NDTTargets(NamedTuple):
    """One target's components, or batched one set per member (a leading
    B on every field)."""

    means: torch.Tensor      # (V,3) voxel means (PAD_COORD when invalid)
    icov6: torch.Tensor      # (V,6) inverse-covariance components (m00,m01,m02,m11,m12,m22)
    valid: torch.Tensor      # (V,) bool: at least min_points_per_voxel points
    slot_keys: torch.Tensor  # (H,) int32 packed voxel key per hash slot (empty: INT32_MAX)
    slot_seg: torch.Tensor   # (H,) int32 voxel (segment) index per hash slot

    @property
    def icovs(self) -> torch.Tensor:
        """(V,3,3) dense view."""
        c = self.icov6
        return c[..., [0, 1, 2, 1, 3, 4, 2, 4, 5]].unflatten(-1, (3, 3))


def _segment_sum(values: torch.Tensor, is_new: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of the rows of `values` (..., N, C), segments being
    runs that start where `is_new` (..., N), per batch member; one row per
    possible segment (N rows, the unused ones zero). Each segment sums in
    row order, as XLA's CPU scatter-add does, with no float atomics."""
    flat = values.reshape(-1, values.shape[-1])
    return torch.segment_reduce(flat, "sum", offsets=_segment_offsets(is_new), axis=0, unsafe=True).reshape(values.shape)


def build_ndt_targets(target: PointCloud, resolution: float, min_points_per_voxel: int = 6) -> NDTTargets:
    """Per-voxel Gaussian components (VoxelGridCovariance equivalent): one
    stable sort of the packed keys (padding last), a count/mean segment
    sum, then the second moments centred on each voxel's mean (one-pass
    E[xx] - m m^T cancels catastrophically in f32 at scene scale), ridge
    flooring at trace/100, the adjugate inverse, and the 4n-slot hash
    table. A batched target gets per-member sorts, sums and tables."""
    n = target.capacity
    lead = target.mask.shape[:-1]
    dev = target.xyz.device
    ijk = torch.floor(target.xyz / resolution).to(torch.int32)
    enc_all = torch.where(target.mask, _encode_keys(ijk), _KEY_PAD)
    enc_s, order = torch.sort(enc_all, dim=-1, stable=True)    # jnp.argsort is stable
    mask_s = take_rows(target.mask, order)
    xyz_s = torch.where(mask_s[..., None], take_rows(target.xyz, order), 0.0)

    is_new = torch.ones(lead + (n,), dtype=torch.bool, device=dev)
    is_new[..., 1:] = enc_s[..., 1:] != enc_s[..., :-1]
    seg = torch.cumsum(is_new.to(torch.int64), -1) - 1

    w = mask_s.to(torch.float32)
    x, y, z = xyz_s[..., 0], xyz_s[..., 1], xyz_s[..., 2]
    first = _segment_sum(torch.stack([w, w * x, w * y, w * z], dim=-1), is_new)
    counts = first[..., 0]
    denom = torch.clamp(counts, min=1.0)
    mx, my, mz = first[..., 1] / denom, first[..., 2] / denom, first[..., 3] / denom
    cx = torch.where(mask_s, x - take_rows(mx, seg), 0.0)
    cy = torch.where(mask_s, y - take_rows(my, seg), 0.0)
    cz = torch.where(mask_s, z - take_rows(mz, seg), 0.0)
    second = _segment_sum(torch.stack([cx * cx, cx * cy, cx * cz, cy * cy, cy * cz, cz * cz], dim=-1), is_new)
    c00, c01, c02, c11, c12, c22 = (second[..., i] / denom for i in range(6))

    # eigenvalue flooring (reference: lambda_max / 100) as a ridge; the
    # trace bounds lambda_max from above
    ridge = torch.clamp((c00 + c11 + c22) / 100.0, min=1e-6)
    icov = _inv_sym3((c00 + ridge, c01, c02, c11 + ridge, c12, c22 + ridge), ridge=0.0)
    valid = counts >= float(min_points_per_voxel)
    means = torch.where(valid[..., None], torch.stack([mx, my, mz], dim=-1), PAD_COORD)

    # Direct-address table: the first row of each voxel writes its key and
    # segment id into its hash slot. Two voxels may hash to one slot: the
    # later one in key order wins, as XLA's CPU scatter applies its
    # updates in order (`scatter_rows`); the loser keeps its Gaussian but
    # cannot be looked up.
    H = 4 * n
    widx = torch.where(is_new & mask_s, _hash_slot(enc_s, H), H)
    slot_keys = scatter_rows(
        torch.full(lead + (H,), _KEY_PAD, dtype=torch.int32, device=dev), widx, enc_s.to(torch.int32)
    )
    slot_seg = scatter_rows(torch.zeros(lead + (H,), dtype=torch.int32, device=dev), widx, seg.to(torch.int32))
    return NDTTargets(means=means, icov6=torch.stack(icov, dim=-1), valid=valid, slot_keys=slot_keys, slot_seg=slot_seg)


# ---------------------------------------------------------------------------
# Moré–Thuente line search (computeStepLengthMT, ndt_omp_impl.hpp:755-1060)
# ---------------------------------------------------------------------------

def _mt_trial_value(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """Moré–Thuente trial value selection (trialValueSelectionMT, cases
    1-4), branchless on 0-d tensors as in the JAX function, including its
    deliberate root-sign fix of case 4 for a_t < a_u."""
    eps = 1e-12

    def safe_div(a, b):
        return a / torch.where(torch.abs(b) < eps, torch.where(b < 0, -eps, eps), b)

    z = 3.0 * safe_div(f_t - f_l, a_t - a_l) - g_t - g_l
    w = torch.sqrt(torch.clamp(z * z - g_t * g_l, min=0.0))
    a_c = a_l + (a_t - a_l) * safe_div(w - g_l - z, g_t - g_l + 2.0 * w)
    a_q = a_l - 0.5 * (a_l - a_t) * safe_div(g_l, g_l - safe_div(f_l - f_t, a_l - a_t))
    a_s = a_l - safe_div(a_l - a_t, g_l - g_t) * g_l
    z4 = 3.0 * safe_div(f_t - f_u, a_t - a_u) - g_t - g_u
    w4 = torch.sqrt(torch.clamp(z4 * z4 - g_t * g_u, min=0.0))
    w4 = torch.where(a_t < a_u, -w4, w4)
    a_c4 = a_u + (a_t - a_u) * safe_div(w4 - g_u - z4, g_t - g_u + 2.0 * w4)
    a_c4 = torch.where(torch.abs(a_t - a_u) < eps, a_t, a_c4)

    case1 = f_t > f_l
    case2 = (~case1) & (g_t * g_l < 0.0)
    case3 = (~case1) & (~case2) & (torch.abs(g_t) <= torch.abs(g_l))

    v1 = torch.where(torch.abs(a_c - a_l) < torch.abs(a_q - a_l), a_c, 0.5 * (a_q + a_c))
    v2 = torch.where(torch.abs(a_c - a_t) >= torch.abs(a_s - a_t), a_c, a_s)
    v3n = torch.where(torch.abs(a_c - a_t) < torch.abs(a_s - a_t), a_c, a_s)
    v3 = torch.where(
        a_t > a_l,
        torch.minimum(a_t + 0.66 * (a_u - a_t), v3n),
        torch.maximum(a_t + 0.66 * (a_u - a_t), v3n),
    )
    out = torch.where(case1, v1, torch.where(case2, v2, torch.where(case3, v3, a_c4)))
    return torch.where(torch.isfinite(out), out, a_t)


def _mt_update_interval(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """Moré–Thuente interval update (updateIntervalMT, cases U1-U3),
    branchless. Returns the new endpoints and the interval-converged flag."""
    u1 = f_t > f_l
    u2 = (~u1) & (g_t * (a_l - a_t) > 0.0)
    u3 = (~u1) & (g_t * (a_l - a_t) < 0.0)
    conv = ~(u1 | u2 | u3)
    n_a_u = torch.where(u1, a_t, torch.where(u3, a_l, a_u))
    n_f_u = torch.where(u1, f_t, torch.where(u3, f_l, f_u))
    n_g_u = torch.where(u1, g_t, torch.where(u3, g_l, g_u))
    rep_l = u2 | u3
    return (
        torch.where(rep_l, a_t, a_l), torch.where(rep_l, f_t, f_l), torch.where(rep_l, g_t, g_l),
        n_a_u, n_f_u, n_g_u, conv,
    )


def _more_thuente_alpha(phi_fn, phi_0, d_phi_0, step_init, step_min, step_max, active=None):
    """The Search Algorithm for T(mu) [Moré, Thuente 1994] on f32 tensors
    of one value per batch member (0-d on the single path): phi_fn(alpha)
    -> (phi, dphi). Runs the auxiliary psi until the interval closes, then
    phi; stops on sufficient decrease and curvature (mu = 1e-4, nu = 0.9),
    interval convergence or 10 trials. Each trial's test is read on the
    host, so the trial count equals JAX's. Batched, the trials run while
    any member's search runs; a member whose search has stopped (or that
    `active` leaves out) keeps its values, so it takes exactly the trials
    of its single call."""
    mu, nu = 1e-4, 0.9
    a_t = torch.minimum(torch.maximum(step_init, step_min), step_max)
    phi_t, dphi_t = phi_fn(a_t)
    g0 = (1.0 - mu) * d_phi_0
    zero = torch.zeros_like(phi_0)
    a_l, f_l, g_l, a_u, f_u, g_u = zero, zero, g0, zero, zero, g0
    open_i = torch.ones(phi_0.shape, dtype=torch.bool, device=phi_0.device)
    conv = ((step_max - step_min) < 0.0).expand(phi_0.shape)
    running = open_i if active is None else active
    for it in range(11):
        psi_t = phi_t - phi_0 - mu * a_t * d_phi_0
        done = (psi_t <= 0.0) & (dphi_t <= -nu * d_phi_0)
        running = running & ~conv & ~done
        if it >= 10 or not bool(running.any()):
            break
        dpsi_t = dphi_t - mu * d_phi_0
        f_t = torch.where(open_i, psi_t, phi_t)
        g_t = torch.where(open_i, dpsi_t, dphi_t)
        a_n = _mt_trial_value(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t)
        a_n = torch.minimum(torch.maximum(a_n, step_min), step_max)
        phi_n, dphi_n = phi_fn(a_n)
        psi_n = phi_n - phi_0 - mu * a_n * d_phi_0
        dpsi_n = dphi_n - mu * d_phi_0

        # the interval closes: endpoints from psi to phi form
        close = open_i & (psi_n <= 0.0) & (dpsi_n >= 0.0)
        n_f_l = torch.where(close, f_l + phi_0 + mu * d_phi_0 * a_l, f_l)
        n_g_l = torch.where(close, g_l + mu * d_phi_0, g_l)
        n_f_u = torch.where(close, f_u + phi_0 + mu * d_phi_0 * a_u, f_u)
        n_g_u = torch.where(close, g_u + mu * d_phi_0, g_u)
        n_open = open_i & ~close

        f_n = torch.where(n_open, psi_n, phi_n)
        g_n = torch.where(n_open, dpsi_n, dphi_n)
        new = _mt_update_interval(a_l, n_f_l, n_g_l, a_u, n_f_u, n_g_u, a_n, f_n, g_n) + (n_open, a_n, phi_n, dphi_n)
        old = (a_l, f_l, g_l, a_u, f_u, g_u, conv, open_i, a_t, phi_t, dphi_t)
        (a_l, f_l, g_l, a_u, f_u, g_u, conv, open_i, a_t, phi_t, dphi_t) = (
            torch.where(running, x, y) for x, y in zip(new, old)
        )
    return a_t


# ---------------------------------------------------------------------------
# The Newton step (computeDerivatives, ndt_omp_impl.hpp:253-341)
# ---------------------------------------------------------------------------

def _mahalanobis(M, r: torch.Tensor):
    """(B r components, r^T B r) of residuals r (...,N,3) under components M."""
    Br = _sym3_vec(M, r[..., 0], r[..., 1], r[..., 2])
    return Br, r[..., 0] * Br[0] + r[..., 1] * Br[1] + r[..., 2] * Br[2]


def _newton_step_comps(p_cur, mu, M, w_gate, gauss_d1: float, gauss_d2: float, lm: float, step_size: float,
                       line_search: str = "more_thuente", tf_eps: float = 1e-3, active=None) -> torch.Tensor:
    """One Newton direction and line search on the NDT score
    F(xi) = sum d1 exp(-d2/2 r^T B r), r = exp(xi) p - mu, on the SE(3)
    tangent: g = sum c u, H = sum c (J^T B J - d2 u u^T) with
    u = J^T B r and c = -d1 d2 e. Returns the accepted tangent step (...,6),
    one per batch member; `active` (batched) names the members whose
    search matters (the others' steps are discarded by the caller)."""
    dev = p_cur.device
    lead = p_cur.shape[:-2]
    px, py, pz = p_cur[..., 0], p_cur[..., 1], p_cur[..., 2]
    Br, m = _mahalanobis(M, p_cur - mu)
    # a negative Mahalanobis means an indefinite icov: dropped, as the
    # reference drops e_x_cov_x > 1
    e = torch.exp(-0.5 * gauss_d2 * torch.clamp(m, max=50.0)) * (m >= 0.0)
    coef = float(torch.clamp(torch.tensor(-gauss_d1), min=1e-12) * gauss_d2)   # the f32 product
    c = coef * e * w_gate

    u0, u1, u2 = Br
    u = (u0, u1, u2, py * u2 - pz * u1, pz * u0 - px * u2, px * u1 - py * u0)
    m00, m01, m02, m11, m12, m22 = (mm * c for mm in M)
    b00 = m01 * pz - m02 * py
    b10 = m11 * pz - m12 * py
    b20 = m12 * pz - m22 * py
    b01 = -m00 * pz + m02 * px
    b11 = -m01 * pz + m12 * px
    b21 = -m02 * pz + m22 * px
    b02 = m00 * py - m01 * px
    b12 = m01 * py - m11 * px
    b22 = m02 * py - m12 * px
    c00 = -(-pz * b10 + py * b20)
    c01 = -(-pz * b11 + py * b21)
    c02 = -(-pz * b12 + py * b22)
    c11 = -(pz * b01 - px * b21)
    c12 = -(pz * b02 - px * b22)
    c22 = -(-py * b02 + px * b12)
    cu = c * gauss_d2
    pairs = [(a, b) for a in range(6) for b in range(a, 6)]
    s = tree_sum(torch.stack(
        [c * ui for ui in u]
        + [m00, m01, m02, m11, m12, m22, b00, b01, b02, b10, b11, b12, b20, b21, b22, c00, c01, c02, c11, c12, c22]
        + [cu * u[a] * u[b] for a, b in pairs],
        dim=-1,
    ))
    g = s[..., :6]
    H_tt = s[..., [6, 7, 8, 7, 9, 10, 8, 10, 11]].unflatten(-1, (3, 3))
    H_tw = -s[..., 12:21].unflatten(-1, (3, 3))
    H_ww = s[..., [21, 22, 23, 22, 24, 25, 23, 25, 26]].unflatten(-1, (3, 3))
    outer = torch.zeros(lead + (6, 6), dtype=s.dtype, device=dev)
    rows, cols = (list(x) for x in zip(*pairs))
    outer[..., rows, cols] = s[..., 27:]
    outer[..., cols, rows] = s[..., 27:]
    H = torch.cat([torch.cat([H_tt, H_tw], -1), torch.cat([H_tw.transpose(-1, -2), H_ww], -1)], -2) - outer
    trace_abs = sum_last(torch.diagonal(torch.abs(H), dim1=-2, dim2=-1))
    H = H + ((lm + 1e-6) * torch.clamp(trace_abs / 6.0, min=1.0))[..., None, None] * torch.eye(6, device=dev)
    # H may be indefinite (the -d2 u u^T term): a float64 LU solve, then
    # the reference's 'not a descent direction -> reverse' rule
    delta = -torch.linalg.solve(H.double(), g.double()[..., None])[..., 0].float()
    delta = torch.where(torch.any(~torch.isfinite(delta), dim=-1, keepdim=True), -g, delta)
    delta = torch.where((sum_last(g * delta) > 0)[..., None], -delta, delta)
    d1w = gauss_d1 * w_gate
    F0 = tree_sum(d1w * e, dim=-1)

    def score_terms(T_a):
        p_a = se3.transform_points(T_a, p_cur)
        Bra, ma = _mahalanobis(M, p_a - mu)
        return p_a, Bra, torch.exp(-0.5 * gauss_d2 * torch.clamp(ma, 0.0, 50.0))

    if line_search == "more_thuente":
        # the reference's wiring: search along the normalised direction,
        # first trial at the Newton-step norm, alpha in [tf_eps/2, step_size]
        nrm = se3.norm(delta)
        dirn = delta / torch.clamp(nrm, min=1e-12)[..., None]
        dv, dw = dirn[..., :3, None], dirn[..., 3:, None]
        d_phi_0 = sum_last(g * dirn)

        def phi_fn(alpha):
            p_a, Bra, ea = score_terms(se3.se3_exp(alpha[..., None] * dirn))
            F = tree_sum(d1w * ea, dim=-1)
            ca = coef * ea * w_gate
            px_, py_, pz_ = p_a[..., 0], p_a[..., 1], p_a[..., 2]
            cx = dw[..., 1, :] * pz_ - dw[..., 2, :] * py_
            cy = dw[..., 2, :] * px_ - dw[..., 0, :] * pz_
            cz = dw[..., 0, :] * py_ - dw[..., 1, :] * px_
            dF = tree_sum(
                ca * (Bra[0] * (dv[..., 0, :] + cx) + Bra[1] * (dv[..., 1, :] + cy) + Bra[2] * (dv[..., 2, :] + cz)),
                dim=-1,
            )
            return F, dF

        alpha = _more_thuente_alpha(
            phi_fn, F0, d_phi_0, step_init=nrm,
            step_min=torch.tensor(tf_eps / 2.0, dtype=torch.float32, device=dev),
            step_max=torch.tensor(step_size, dtype=torch.float32, device=dev),
            active=active,
        )
        alpha = torch.where(d_phi_0 >= 0.0, 0.0, alpha)   # degenerate direction: no move
        return alpha[..., None] * dirn

    # "armijo": the first of 5 backtracking candidates with sufficient
    # decrease (else the smallest); one step moves at most 10 step sizes
    cap = 10.0 * step_size
    nrm = se3.norm(delta)
    delta = delta * torch.clamp(cap / torch.clamp(nrm, min=1e-12), max=1.0)[..., None]
    gTd = sum_last(g * delta)
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125, 0.0625], dtype=torch.float32, device=dev)
    Fs = torch.stack([tree_sum(d1w * score_terms(se3.se3_exp(a * delta))[2], dim=-1) for a in alphas], dim=-1)
    ok = Fs <= F0[..., None] + 1e-4 * alphas * gTd[..., None]
    alpha = torch.where(torch.any(ok, dim=-1), alphas[torch.argmax(ok.to(torch.int8), dim=-1)], alphas[-1])
    return alpha[..., None] * delta


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------

def _gauss_constants(res: float, outlier_ratio: float):
    """gauss_d1, gauss_d2 of the reference's outlier-ratio mixture
    (ndt_omp_impl computeTransformation), in f32 as the JAX function
    computes them, returned as Python floats (exact f32 values)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (res ** 3)
    d3 = -torch.log(f32(c2))
    d1 = -torch.log(f32(c1 + c2)) - d3
    d2 = -2.0 * torch.log((-torch.log(f32(c1) * torch.exp(f32(-0.5)) + c2) - d3) / d1)
    return float(d1), float(d2)


def ndt_register(
    source: PointCloud,
    target: PointCloud,
    guess: Optional[torch.Tensor] = None,
    cfg: RegistrationConfig = RegistrationConfig(),
    outlier_ratio: float = 0.55,
    **_unused,
) -> GICPResult:
    """Align `source` to `target` with the NDT Gaussian-voxel objective;
    returns the source->target transform (guess included). With a leading
    batch dimension on the clouds (and the guess), each member is aligned
    as its own single call would align it."""
    if cfg.ndt_neighborhood not in _OFFSETS:
        raise ValueError(
            f"ndt_neighborhood must be direct1|direct7|direct26|kdtree, got {cfg.ndt_neighborhood!r}"
        )
    dev = source.xyz.device
    lead = source.mask.shape[:-1]
    if guess is None:
        guess = se3.identity(dev)
    res = cfg.ndt_resolution
    targets = build_ndt_targets(target, res)
    gauss_d1, gauss_d2 = _gauss_constants(res, outlier_ratio)

    src0 = se3.transform_points(guess, source.xyz)
    src0 = torch.where(source.mask[..., None], src0, source.xyz)

    # KDTREE gate: the reference radius-searches occupied-leaf centroids
    # within one resolution; such a centroid lies in the query voxel's
    # 3x3x3 block, so the DIRECT26 gather plus a centroid-distance test
    # reproduces it
    kdtree_gate = cfg.ndt_neighborhood == "kdtree"
    offs = torch.tensor(_OFFSETS[cfg.ndt_neighborhood], dtype=torch.int32, device=dev)
    K = offs.shape[0]
    n_src = source.capacity
    table = targets.slot_keys.shape[-1]
    src0f = src0.repeat_interleave(K, dim=-2)
    maskf = source.mask.repeat_interleave(K, dim=-1)

    def lookup(p):
        """Each point's K candidate voxels in its member's table: (segment
        index, hit)."""
        keyq = _encode_keys(torch.floor(p / res).to(torch.int32)[..., :, None, :] + offs).flatten(-2)
        slot = _hash_slot(keyq, table)
        idx = take_rows(targets.slot_seg, slot).to(torch.int64)
        return idx, (take_rows(targets.slot_keys, slot).to(torch.int64) == keyq) & take_rows(targets.valid, idx)

    def outer_body(use_newton, T, active):
        p = se3.transform_points(T, src0)
        jf, hit = lookup(p)
        pf = p.repeat_interleave(K, dim=-2)
        mu = torch.where(hit[..., None], take_rows(targets.means, jf), pf)    # misses: zero residual
        if kdtree_gate:
            dmu = pf - mu
            hit = hit & (sum_last(dmu * dmu) <= res * res)
        w_gate = (maskf & hit).to(torch.float32)
        icov = take_rows(targets.icov6, jf)
        M = tuple(icov[..., i] for i in range(6))
        r = pf - mu
        _, maha = _mahalanobis(M, r)
        w = w_gate * torch.exp(-0.5 * gauss_d2 * torch.clamp(maha, max=50.0)) * (maha >= 0.0)

        if use_newton:
            p_cur = torch.where(maskf[..., None], se3.transform_points(T, src0f), mu)
            step = _newton_step_comps(
                p_cur, mu, M, w_gate, gauss_d1, gauss_d2, cfg.levenberg_lambda, cfg.ndt_step_size,
                line_search=cfg.ndt_line_search, tf_eps=cfg.tf_epsilon, active=active,
            )
            T_new = se3.compose(se3.se3_exp(step), T)
        else:
            T_new = T
            for _ in range(cfg.inner_iterations):
                p_cur = torch.where(maskf[..., None], se3.transform_points(T_new, src0f), mu)
                dx = _gauss_newton_step_comps(p_cur, mu, M, w, cfg.levenberg_lambda)
                T_new = se3.compose(se3.se3_exp(dx), T_new)
        T_new = se3.make_transform(se3.orthonormalize(se3.rotation(T_new)), se3.translation(T_new))
        delta = _scaled_delta(T, T_new, cfg)
        # fitness: squared distance to the nearest hit component per point
        d2k = sum_last(r * r).unflatten(-1, (n_src, K))
        d2min = torch.amin(torch.where(hit.unflatten(-1, (n_src, K)), d2k, float("inf")), dim=-1)
        matched = source.mask & torch.isfinite(d2min)
        nmatch = torch.sum(matched, dim=-1, dtype=torch.int32)
        fitness = tree_sum(torch.where(matched, d2min, 0.0), dim=-1) / torch.clamp(nmatch.to(torch.float32), min=1.0)
        return T_new, delta, fitness, nmatch

    def run(carry, max_it, use_newton):
        """The outer loop, while any member iterates; a member that has
        stopped keeps its carry."""
        T, it, delta, fitness, ncorr = carry
        while True:
            active = (it < max_it) & (delta >= 1.0)
            if not bool(active.any()):
                break
            new = outer_body(use_newton, T, active)
            T, delta, fitness, ncorr = (select(active, a, b) for a, b in zip(new, (T, delta, fitness, ncorr)))
            it = it + active.to(torch.int32)
        return T, it, delta, fitness, ncorr

    inf = torch.full(lead, float("inf"), device=dev)
    zero = torch.zeros(lead, dtype=torch.int32, device=dev)
    carry = (se3.identity(dev).expand(lead + (4, 4)), zero, inf, inf, zero)
    use_newton = cfg.ndt_optimizer == "newton"
    if use_newton and cfg.ndt_newton_warmstart > 0:
        # IRLS warm start: a few full Gauss-Newton iterations on the same
        # weighted objective reach the quadratic basin; Newton +
        # Moré–Thuente then polish. Convergence re-opens for the Newton
        # phase only when that phase can still run.
        carry = run(carry, min(cfg.ndt_newton_warmstart, cfg.iterations), False)
        T, it, delta, fitness, ncorr = carry
        carry = (T, it, torch.where(it < cfg.iterations, inf, delta), fitness, ncorr)
    T_fin, iters, delta, fitness, ncorr = run(carry, cfg.iterations, use_newton)

    final = se3.compose(T_fin, guess)
    # Final correspondences against the raw target points, for the
    # covariance downstream: kernel B2 (batched B3) at SCAN_BT, bounded at
    # corr_dist (anything farther is gated below anyway); the dense 1-NN
    # where the JAX function takes it, below 128 source points.
    p_fin = torch.where(source.mask[..., None], se3.transform_points(final, source.xyz), source.xyz)
    if source.capacity >= 128:
        t_aug = build_nn_target(target.xyz, bt=SCAN_BT)
        c_min, c_max = chunk_boxes(target.xyz, target.mask, t_aug.shape[-2], bt=SCAN_BT)
        d2_fin, j_fin = nearest_bounded_pre(p_fin, t_aug, target.xyz, c_min, c_max, float(cfg.corr_dist), bt=SCAN_BT)
        d2_fin = torch.where(torch.isfinite(d2_fin), d2_fin, 1e12)
    else:
        d2_fin, j_fin = neighbors.nearest(p_fin, target.xyz)
    corr_mask = source.mask & take_rows(target.mask, j_fin) & (d2_fin <= cfg.corr_dist ** 2)
    return GICPResult(
        transform=final,
        converged=delta < 1.0,
        iterations=iters,
        fitness=fitness,
        correspondences=j_fin,
        corr_mask=corr_mask,
        num_correspondences=ncorr,
    )


register_method("ndt")(ndt_register)
