"""The benchmark's traffic generator: lidar sweeps ray-cast through a
procedural tunnel, with the IMU and wheel-odometry streams that go with
them, all made from one seed.

Frozen copy, rewritten in PyTorch so that it runs on the card in a few
large calls, of `locus_tpu_torch/io/synthetic.py` (`BoxWorld.default_tunnel`,
`BoxWorld.raycast`, `vlp16_directions`, `simulate_scan`, `make_trajectory`)
and `locus_tpu_torch/io/dataset.py` (`make_tunnel_sequence`'s IMU and
odometry streams), at commit 94db2e9. A change to the program does not
move it. Departures from the copied code: the pillars' positions and the
trajectory's sway phase are drawn from the seed (the pillars keep 1.6-2.5
m off the centreline, so that the path stays clear at every phase), the
speed is the configuration's, and the range noise is drawn on the device.

Every seed gives the same number of sweeps, rays and pillars, at the same
speed: the seed moves where things are, not how much work there is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Sweeps:
    """One robot's traffic, host numpy except the clouds.

    xyz (S, L, R, 3) f32 and valid (S, L, R) bool on `device`: S sweeps of
    L lidars of R rays each, every point in its own lidar's frame.
    stamps (S,), gt (S, 4, 4) base poses, the IMU stream (imu_stamps (Ti,),
    imu_quats (Ti, 4) wxyz) and the odometry stream (odom_stamps (To,),
    odom_poses (To, 4, 4))."""

    xyz: torch.Tensor
    valid: torch.Tensor
    stamps: np.ndarray
    gt: np.ndarray
    imu_stamps: np.ndarray
    imu_quats: np.ndarray
    odom_stamps: np.ndarray
    odom_poses: np.ndarray

    def __len__(self) -> int:
        return self.stamps.shape[0]


def xyzrpy_to_matrix(xyzrpy) -> np.ndarray:
    """[x, y, z, roll, pitch, yaw] -> 4x4 (R = Rz(yaw) Ry(pitch) Rx(roll))."""
    x, y, z, roll, pitch, yaw = (float(v) for v in xyzrpy)
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    T[:3, 3] = [x, y, z]
    return T


def tunnel_world(length: float, rng: np.random.Generator, pillar_every: float = 8.0):
    """default_tunnel: one shell 8 m wide and 5 m high, and a pillar every
    `pillar_every` metres, alternating sides. Returns (shells, obstacles),
    each a list of (lo, hi) corners."""
    shells = [(np.array([-5.0, -4.0, -1.5]), np.array([length + 5.0, 4.0, 3.5]))]
    obstacles = []
    x = pillar_every
    while x < length:
        side = 1.0 if (int(x) // 8) % 2 == 0 else -1.0
        cx = x + rng.uniform(-1.0, 1.0)
        cy = side * rng.uniform(1.6, 2.5)
        obstacles.append((np.array([cx - 0.4, cy - 0.4, -1.5]), np.array([cx + 0.4, cy + 0.4, 1.5])))
        x += pillar_every
    return shells, obstacles


def trajectory(num_sweeps: int, step: float, phase: float) -> np.ndarray:
    """make_trajectory: forward along +x at a constant `step` metres a
    sweep, with a 0.8 m sinusoidal sway and the yaw that follows it.
    (S, 4, 4) float64."""
    s = step * np.arange(num_sweeps, dtype=np.float64)
    y = 0.8 * np.sin(0.12 * s + phase)
    yaw = np.arctan(0.8 * 0.12 * np.cos(0.12 * s + phase))
    poses = np.tile(np.eye(4), (num_sweeps, 1, 1))
    c, sn = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1], poses[:, 1, 0], poses[:, 1, 1] = c, -sn, sn, c
    poses[:, 0, 3], poses[:, 1, 3] = s, y
    return poses


def vlp16_directions(azimuth_steps: int, rings: int = 16, fov_deg: float = 15.0) -> np.ndarray:
    """(azimuth_steps * rings, 3) unit rays: `rings` elevations over
    +-fov_deg, azimuth-major as the copied sensor model orders them."""
    elev = np.deg2rad(np.linspace(-fov_deg, fov_deg, rings))
    azim = np.linspace(0.0, 2 * np.pi, azimuth_steps, endpoint=False)
    az, el = np.meshgrid(azim, elev, indexing="ij")
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1)
    return d.reshape(-1, 3)


def raycast(shells, obstacles, origins: torch.Tensor, dirs: torch.Tensor, max_range: float):
    """BoxWorld.raycast on tensors: origins (..., 3) broadcast against
    dirs (..., R, 3), float64. Shells form a union of free space (a ray
    goes on while its exit point lies inside another shell); obstacles are
    hit from outside. Returns (t (..., R), valid (..., R))."""
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12), dirs)
    o = origins[..., None, :]

    def slab(lo, hi):
        lo = torch.as_tensor(lo, dtype=dirs.dtype, device=dirs.device)
        hi = torch.as_tensor(hi, dtype=dirs.dtype, device=dirs.device)
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        return torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1)

    shell_ee = [slab(lo, hi) for lo, hi in shells]
    eps = 1e-9
    t_exit = torch.zeros(dirs.shape[:-1], dtype=dirs.dtype, device=dirs.device)
    for _ in range(max(len(shells), 1)):
        new_t = t_exit
        for enter, exit_ in shell_ee:
            covers = (enter <= t_exit + eps) & (exit_ > t_exit + eps)
            new_t = torch.where(covers, torch.maximum(new_t, exit_), new_t)
        if bool(torch.all(new_t <= t_exit + eps)):
            break
        t_exit = new_t
    t_best = torch.where(t_exit > eps, t_exit, torch.full_like(t_exit, max_range)).clamp(max=max_range)
    for lo, hi in obstacles:
        enter, exit_ = slab(lo, hi)
        hit = (enter > 1e-9) & (enter < exit_)
        t_best = torch.where(hit, torch.minimum(t_best, enter), t_best)
    return t_best, t_best < max_range - 1e-6


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix (dataset._mat_to_quat)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    if i == 1:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        return np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s])
    s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
    return np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s])


CHUNK = 16   # sweeps ray-cast in one call


def make_sweeps(sensor: dict, num_sweeps: int, seed: int, device, step: float) -> Sweeps:
    """One robot's traffic from `seed`: the rig of `sensor` (the config
    file's "sensor" block: lidars, azimuth steps, rings, rates, noise),
    driven `num_sweeps` sweeps down a tunnel at `step` metres a sweep."""
    rng = np.random.default_rng(seed)
    phase = float(rng.uniform(0.0, 2.0 * np.pi))
    gt = trajectory(num_sweeps, step, phase)
    length = float(gt[-1, 0, 3]) + 30.0
    shells, obstacles = tunnel_world(length, rng)
    rate = float(sensor["sweep_hz"])
    stamps = np.arange(num_sweeps) / rate

    extr = np.stack([xyzrpy_to_matrix(v) for v in sensor["lidars"].values()])      # (L, 4, 4)
    dirs_s = torch.as_tensor(vlp16_directions(sensor["azimuth_steps"], sensor["rings"], sensor["fov_deg"]),
                             dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    num_l, num_r = extr.shape[0], dirs_s.shape[0]
    xyz = torch.empty((num_sweeps, num_l, num_r, 3), dtype=torch.float32, device=device)
    valid = torch.empty((num_sweeps, num_l, num_r), dtype=torch.bool, device=device)
    for a in range(0, num_sweeps, CHUNK):
        b = min(a + CHUNK, num_sweeps)
        lidar = torch.as_tensor(gt[a:b, None] @ extr[None], dtype=torch.float64, device=device)  # (c, L, 4, 4)
        R, t = lidar[..., :3, :3], lidar[..., :3, 3]
        dirs_w = torch.einsum("clij,rj->clri", R, dirs_s)
        tt, ok = raycast(shells, obstacles, t, dirs_w, float(sensor["max_range_m"]))
        # hits back in the lidar frame: the ray's own direction at range t
        pts = dirs_s * tt[..., None]
        rr = pts.norm(dim=-1, keepdim=True)
        noise = torch.randn(rr.shape, generator=gen, dtype=torch.float64, device=device)
        pts = pts * (1.0 + noise * float(sensor["range_noise"]) / rr.clamp(min=1.0))
        xyz[a:b] = pts.float()
        valid[a:b] = ok

    imu_hz = float(sensor["imu_hz"])
    n_imu = int(num_sweeps / rate * imu_hz)
    imu_stamps = np.arange(n_imu) / imu_hz
    rows = np.minimum((imu_stamps * rate).astype(int), num_sweeps - 1)
    imu_quats = np.stack([_mat_to_quat(gt[i, :3, :3]) for i in rows]) if n_imu else np.zeros((0, 4))
    odom = gt.copy()
    odom[:, :3, 3] += np.cumsum(rng.normal(scale=float(sensor["odom_drift_m"]), size=(num_sweeps, 3)), axis=0)
    return Sweeps(xyz=xyz, valid=valid, stamps=stamps, gt=gt, imu_stamps=imu_stamps, imu_quats=imu_quats,
                  odom_stamps=stamps.copy(), odom_poses=odom)


def extrinsics(sensor: dict) -> np.ndarray:
    """(L, 4, 4) lidar -> base transforms of the rig, in the file's order."""
    return np.stack([xyzrpy_to_matrix(v) for v in sensor["lidars"].values()])

