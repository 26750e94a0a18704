"""SE(3) / SO(3) utilities on tensors (counterpart of
`locus_tpu/geometry/se3.py`).

Transforms are (...,4,4) homogeneous float32 matrices; functions batch over
leading dimensions. Rotations use the ZYX Euler convention of the
reference's `applyState`, and the se(3) exp/log maps serve the
Gauss-Newton solver.

Matrix products and norms are written out as elementwise sums of
products in a fixed order (`matmul`, `matvec`, `_dot`) instead of
`torch.matmul`/`einsum`/`linalg.norm`: a batched product or reduction may
sum in another order than a single one, and the batched replay must give
each member the bits of its single replay.
"""
from __future__ import annotations

import torch

from locus_tpu_torch.utils.linalg import sum_last

_EPS = 1e-9


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(...,n,k) @ (...,k,m), summed over k from left to right."""
    return sum_last(A[..., :, None, :] * B.transpose(-1, -2)[..., None, :, :])


def matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(...,n,k) @ (...,k), summed over k from left to right."""
    return sum_last(A * v[..., None, :])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(...,k) . (...,k) -> (...), summed from left to right."""
    return sum_last(a * b)


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt(_dot(v, v))


# ---------------------------------------------------------------------------
# Basic constructors
# ---------------------------------------------------------------------------

def identity(device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build a 4x4 transform from (...,3,3) rotation and (...,3) translation."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return make_transform(Rt, -matvec(Rt, translation(T)))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A then-applied-after B: returns A @ B."""
    return matmul(A, B)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) transform to (...,N,3) points."""
    return rotate_vectors(T, pts) + translation(T)[..., None, :]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of (...,4,4) to (...,N,3) vectors (normals)."""
    return sum_last(vecs[..., :, None, :] * rotation(T)[..., None, :, :])


# ---------------------------------------------------------------------------
# skew / so(3)
# ---------------------------------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _rodrigues_coeffs(theta2: torch.Tensor):
    """(a, b, theta) of exp: a = sin t / t, b = (1 - cos t) / t^2, with
    Taylor forms below t^2 = 1e-4, where (1 - cos t)/t^2 cancels
    catastrophically in f32."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    return a, b, small


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation. Safe at 0."""
    theta2 = _dot(w, w)
    a, b, _ = _rodrigues_coeffs(theta2)
    W = skew(w)
    W2 = matmul(W, W)
    eye = _eye(3, w).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,3) axis-angle. Safe near identity and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    ) * 0.5
    sin_theta = torch.sin(theta)
    small = theta < 1e-2
    scale = torch.where(
        small,
        1.0 + theta * theta / 6.0,
        theta / torch.where(small, torch.ones_like(sin_theta), sin_theta + _EPS),
    )
    w = v * scale[..., None]
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / torch.clamp(1.0 - cos_theta[..., None], min=_EPS),
        min=0.0,
    )
    axis = torch.sqrt(axis_sq)
    sign = torch.stack(
        [
            torch.sign(R[..., 2, 1] - R[..., 1, 2] + _EPS),
            torch.sign(R[..., 0, 2] - R[..., 2, 0] + _EPS),
            torch.sign(R[..., 1, 0] - R[..., 0, 1] + _EPS),
        ],
        dim=-1,
    )
    w_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


# ---------------------------------------------------------------------------
# se(3)
# ---------------------------------------------------------------------------

def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(...,6) twist [v, w] -> (...,4,4). v translational, w rotational."""
    v = xi[..., :3]
    w = xi[..., 3:]
    theta2 = _dot(w, w)
    a, b, small = _rodrigues_coeffs(theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / (theta2 + _EPS))
    W = skew(w)
    W2 = matmul(W, W)
    eye = _eye(3, xi).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = matvec(V, v)
    return make_transform(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) -> (...,6) twist [v, w]."""
    w = so3_log(rotation(T))
    theta2 = _dot(w, w)
    a, b, small = _rodrigues_coeffs(theta2)
    W = skew(w)
    W2 = matmul(W, W)
    eye = _eye(3, T).expand(W.shape)
    # V^{-1} = I - W/2 + (1/theta2)(1 - a/(2b)) W^2
    coef = torch.where(small, torch.full_like(a, 1.0 / 12.0), (1.0 - a / (2.0 * b + _EPS)) / (theta2 + _EPS))
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = matvec(Vinv, translation(T))
    return torch.cat([v, w], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(norm(q)[..., None], min=_EPS)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(...,4) wxyz quaternion -> (...,3,3)."""
    q = _unit(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) wxyz. Branch-free Shepperd-style construction."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 0.5
    cand = torch.stack(
        [
            torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)], dim=-1),
            torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)], dim=-1),
            torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)], dim=-1),
            torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz], dim=-1),
        ],
        dim=-2,
    )
    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = _unit(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Spherical interpolation between (...,4) quaternions."""
    dot = _dot(q0, q1)[..., None]
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / safe)
    w1 = torch.where(small, alpha * torch.ones_like(theta), torch.sin(alpha * theta) / safe)
    return _unit(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# Euler (ZYX, matching reference applyState convention)
# ---------------------------------------------------------------------------

def euler_zyx_to_matrix(roll, pitch, yaw) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_euler_zyx(R: torch.Tensor):
    """Returns (roll, pitch, yaw) with R = Rz(yaw) Ry(pitch) Rx(roll)."""
    pitch = -torch.arcsin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def yaw_only_matrix(R: torch.Tensor) -> torch.Tensor:
    """Project a rotation to its yaw component."""
    _, _, yaw = matrix_to_euler_zyx(R)
    zero = torch.zeros_like(yaw)
    return euler_zyx_to_matrix(zero, zero, yaw)


# ---------------------------------------------------------------------------
# Deltas / metrics
# ---------------------------------------------------------------------------

def pose_delta(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """prev^{-1} @ cur (reference GetOdometryDelta, Locus.cc:775-778)."""
    return compose(inverse(prev), cur)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Geodesic angle of a rotation matrix in radians."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    return norm(translation(T))


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) via Gram-Schmidt."""
    x = R[..., :, 0]
    y = R[..., :, 1]
    x = x / torch.clamp(norm(x)[..., None], min=_EPS)
    y = y - _dot(x, y)[..., None] * x
    y = y / torch.clamp(norm(y)[..., None], min=_EPS)
    z = torch.linalg.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)
