"""Dataset replay: synthetic sequence generation and npz round-trip.

A numpy copy of `locus_tpu/io/dataset.py`, kept in the port so that it
runs without JAX.

The reference replays nebula-odometry-dataset rosbags through tmuxp
(tmuxp_config/run_nebula_odometry_dataset/). Those bags are not
distributable here, so sequences are generated by raycasting a VLP-16
model through procedural worlds (io.synthetic) — same data contract:
per-scan base-frame point clouds + IMU orientation + wheel-odometry
streams + ground-truth poses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from locus_tpu_torch.io import synthetic


@dataclass
class Sequence:
    """A replayable sequence. Arrays are host-side numpy; the runner
    device-puts fixed-shape slices per scan."""

    scans: np.ndarray        # (T, M, 3) sensor-frame points
    scan_valid: np.ndarray   # (T, M) bool
    stamps: np.ndarray       # (T,)
    gt_poses: np.ndarray     # (T, 4, 4)
    imu_stamps: Optional[np.ndarray] = None   # (Ti,)
    imu_quats: Optional[np.ndarray] = None    # (Ti,4) wxyz
    odom_stamps: Optional[np.ndarray] = None  # (To,)
    odom_poses: Optional[np.ndarray] = None   # (To,4,4)

    def __len__(self):
        return self.scans.shape[0]

    def save(self, path: str):
        np.savez_compressed(
            path,
            scans=self.scans,
            scan_valid=self.scan_valid,
            stamps=self.stamps,
            gt_poses=self.gt_poses,
            **{
                k: getattr(self, k)
                for k in ("imu_stamps", "imu_quats", "odom_stamps", "odom_poses")
                if getattr(self, k) is not None
            },
        )

    @staticmethod
    def load(path: str) -> "Sequence":
        z = np.load(path)
        return Sequence(
            scans=z["scans"],
            scan_valid=z["scan_valid"],
            stamps=z["stamps"],
            gt_poses=z["gt_poses"],
            imu_stamps=z.get("imu_stamps"),
            imu_quats=z.get("imu_quats"),
            odom_stamps=z.get("odom_stamps"),
            odom_poses=z.get("odom_poses"),
        )


def make_world_sequence(
    world_name: str,
    num_scans: int = 50,
    azimuth_steps: int = 450,
    step: float = 0.35,
    rate_hz: float = 10.0,
    noise: float = 0.005,
    seed: int = 0,
):
    """Sequence through a named world: "tunnel" | "urban" | "cave" |
    "loop" | "circuit" (the dataset-matrix analogs of the nebula
    tunnel/urban/cave circuits; "loop" is a closed circuit in a
    pillared hall that returns to the start — the loop-closure /
    revisit scenario; "circuit" is the 2-lap square-ring endurance
    tunnel of make_circuit_sequence)."""
    if world_name == "circuit":
        return make_circuit_sequence(
            num_scans=num_scans, step=step, laps=2,
            azimuth_steps=azimuth_steps, rate_hz=rate_hz, noise=noise,
            seed=seed,
        )
    length = num_scans * step + 30.0
    if world_name == "loop":
        radius = num_scans * step / (2.0 * np.pi)
        margin = radius + 8.0
        world = synthetic.BoxWorld()
        world.add_shell(
            [-margin, -8.0, -1.5], [margin, 2.0 * radius + 8.0, 3.0]
        )
        rng = np.random.default_rng(seed + 11)
        for _ in range(12):
            cx = rng.uniform(-margin + 2, margin - 2)
            cy = rng.uniform(-5.0, 2.0 * radius + 5.0)
            # keep pillars off the circular path (centered at (0, radius))
            if abs(np.hypot(cx, cy - radius) - radius) < 1.5:
                continue
            world.add_obstacle(
                [cx - 0.3, cy - 0.3, -1.5], [cx + 0.3, cy + 0.3, 2.0]
            )
        gt = synthetic.make_loop_trajectory(num_scans, radius=radius)
        scans, valids = [], []
        for i in range(num_scans):
            pts, valid = synthetic.simulate_scan(
                world, gt[i], azimuth_steps=azimuth_steps, noise=noise,
                seed=seed + i,
            )
            scans.append(pts)
            valids.append(valid)
        stamps = np.arange(num_scans) / rate_hz
        return _with_simulated_sensors(
            Sequence(
                scans=np.stack(scans), scan_valid=np.stack(valids),
                stamps=stamps, gt_poses=gt,
            ),
            rate_hz=rate_hz,
            seed=seed,
        )
    if world_name == "tunnel":
        world = synthetic.BoxWorld.default_tunnel(length=length)
    elif world_name == "urban":
        world = synthetic.BoxWorld.urban(length=length)
    elif world_name == "cave":
        world = synthetic.BoxWorld.cave(length=length, seed=seed + 5)
    else:
        raise ValueError(world_name)
    return make_tunnel_sequence(
        num_scans=num_scans, azimuth_steps=azimuth_steps, step=step,
        rate_hz=rate_hz, noise=noise, seed=seed, world=world,
    )


def circuit_geometry(
    num_scans: int,
    step: float = 0.5,
    laps: int = 2,
    corner_radius: float = 3.0,
    half_width: float = 4.0,
    seed: int = 0,
):
    """Shared circuit sizing: (world, gt_poses, side) for a square-ring
    circuit whose `laps` laps cover num_scans * step meters of path.
    ONE home for the geometry formulas so the full-scale endurance tool
    and the scaled CI test exercise the same world family. The corner
    radius is clamped so the rounded-square path stays non-degenerate
    (side > 2*rc; short circuits would otherwise get negative straight
    lengths and a self-intersecting trajectory with pose teleports)."""
    rc = corner_radius
    path_per_lap = num_scans * step / laps
    # side as a function of rc: P = 4*(side - 2rc) + 2*pi*rc
    side = (path_per_lap + 8.0 * rc - 2.0 * np.pi * rc) / 4.0
    if side < 3.0 * rc:
        # re-solve with a smaller radius: rc = side/3 and the perimeter
        # equation together give side directly
        side = path_per_lap / (4.0 + (2.0 * np.pi - 8.0) / 3.0)
        rc = side / 3.0
    world = synthetic.circuit_world(
        side=side,
        half_width=half_width,
        # scale feature cadence down with the circuit so small (CI)
        # circuits keep pillars/rooms — a bare corridor is degenerate
        # along its axis and would measure drift, not endurance
        pillar_every=min(8.0, max(2.5, side / 8.0)),
        room_every=min(30.0, max(6.0, side / 2.0)),
        seed=seed + 11,
    )
    gt = synthetic.make_circuit_trajectory(
        num_scans, side=side, corner_radius=rc, laps=laps
    )
    return world, gt, side


def make_circuit_sequence(
    num_scans: int,
    step: float = 0.5,
    laps: int = 2,
    azimuth_steps: int = 900,
    rate_hz: float = 10.0,
    noise: float = 0.005,
    corner_radius: float = 3.0,
    half_width: float = 4.0,
    seed: int = 0,
) -> Sequence:
    """Multi-lap closed-circuit sequence (the endurance world): the
    square-ring tunnel of synthetic.circuit_world, sized so that `laps`
    laps cover num_scans * step meters of path. Lap 2+ retraces lap 1 —
    the sustained revisit / ring-wrap / MSW-cycling scenario of the
    reference's full SubT dataset replays
    (tmuxp_config/run_nebula_odometry_dataset/)."""
    world, gt, _side = circuit_geometry(
        num_scans, step=step, laps=laps, corner_radius=corner_radius,
        half_width=half_width, seed=seed,
    )
    scans, valids = [], []
    for i in range(num_scans):
        pts, valid = synthetic.simulate_scan(
            world, gt[i], azimuth_steps=azimuth_steps, noise=noise,
            seed=seed + i,
        )
        scans.append(pts)
        valids.append(valid)
    return _with_simulated_sensors(
        Sequence(
            scans=np.stack(scans),
            scan_valid=np.stack(valids),
            stamps=np.arange(num_scans) / rate_hz,
            gt_poses=gt,
        ),
        rate_hz=rate_hz,
        seed=seed,
    )


def _with_simulated_sensors(
    seq: Sequence,
    rate_hz: float = 10.0,
    imu_rate_hz: float = 100.0,
    odom_noise: float = 0.002,
    seed: int = 0,
) -> Sequence:
    """Attach simulated IMU (GT orientation at imu_rate) and wheel
    odometry (GT poses + drift noise) streams to a lidar-only Sequence —
    same sensor model as make_tunnel_sequence."""
    rng = np.random.default_rng(seed)
    gt = seq.gt_poses
    num_scans = len(seq)
    n_imu = int(num_scans / rate_hz * imu_rate_hz)
    imu_stamps = np.arange(n_imu) / imu_rate_hz
    imu_quats = np.zeros((n_imu, 4))
    for k, t in enumerate(imu_stamps):
        i = min(int(t * rate_hz), num_scans - 1)
        imu_quats[k] = _mat_to_quat(gt[i, :3, :3])
    odom_poses = gt.copy()
    drift = np.cumsum(rng.normal(scale=odom_noise, size=(num_scans, 3)), axis=0)
    odom_poses[:, :3, 3] += drift
    return Sequence(
        scans=seq.scans,
        scan_valid=seq.scan_valid,
        stamps=seq.stamps,
        gt_poses=gt,
        imu_stamps=imu_stamps,
        imu_quats=imu_quats,
        odom_stamps=seq.stamps.copy(),
        odom_poses=odom_poses,
    )


def make_tunnel_sequence(
    num_scans: int = 50,
    azimuth_steps: int = 450,
    step: float = 0.35,
    rate_hz: float = 10.0,
    noise: float = 0.005,
    imu_rate_hz: float = 100.0,
    odom_noise: float = 0.002,
    seed: int = 0,
    world: Optional[synthetic.BoxWorld] = None,
) -> Sequence:
    """Simulate a husky-style tunnel run with IMU + wheel odometry."""
    rng = np.random.default_rng(seed)
    if world is None:
        world = synthetic.BoxWorld.default_tunnel(length=num_scans * step + 30.0)
    gt = synthetic.make_trajectory(num_scans, step=step, seed=seed)
    stamps = np.arange(num_scans) / rate_hz

    scans = []
    valids = []
    for i in range(num_scans):
        pts, valid = synthetic.simulate_scan(
            world, gt[i], azimuth_steps=azimuth_steps, noise=noise, seed=seed + i
        )
        scans.append(pts)
        valids.append(valid)
    scans = np.stack(scans)
    valids = np.stack(valids)

    # IMU: ground-truth orientation sampled at imu_rate (quat wxyz)
    n_imu = int(num_scans / rate_hz * imu_rate_hz)
    imu_stamps = np.arange(n_imu) / imu_rate_hz
    imu_quats = np.zeros((n_imu, 4))
    for k, t in enumerate(imu_stamps):
        i = min(int(t * rate_hz), num_scans - 1)
        R = gt[i, :3, :3]
        imu_quats[k] = _mat_to_quat(R)

    # wheel odometry: gt poses with drift noise at scan rate
    odom_poses = gt.copy()
    drift = np.cumsum(rng.normal(scale=odom_noise, size=(num_scans, 3)), axis=0)
    odom_poses[:, :3, 3] += drift

    return Sequence(
        scans=scans,
        scan_valid=valids,
        stamps=stamps,
        gt_poses=gt,
        imu_stamps=imu_stamps,
        imu_quats=imu_quats,
        odom_stamps=stamps.copy(),
        odom_poses=odom_poses,
    )


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = np.argmax(np.diag(R))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    if i == 1:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        return np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s])
    s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
    return np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s])


def sensor_windows_for_scan(
    seq: Sequence, scan_index: int, imu_window: int = 16, odom_window: int = 4
):
    """Fixed-shape per-scan sensor windows ending at the scan stamp
    (padding stamp = -inf). The host-side analog of the reference's
    callback-queue buffers."""
    t = seq.stamps[scan_index]
    t_prev = seq.stamps[scan_index - 1] if scan_index > 0 else -np.inf

    def window(stamps, n):
        if stamps is None:
            return np.full((n,), -np.inf, np.float32), np.zeros((n,), np.int64)
        sel = np.nonzero((stamps > t_prev) & (stamps <= t))[0][-n:]
        pad = n - sel.size
        w_stamps = np.concatenate([np.full(pad, -np.inf), stamps[sel]]).astype(np.float32)
        w_idx = np.concatenate([np.zeros(pad, np.int64), sel])
        return w_stamps, w_idx

    imu_s, imu_i = window(seq.imu_stamps, imu_window)
    odom_s, odom_i = window(seq.odom_stamps, odom_window)
    imu_q = (
        seq.imu_quats[imu_i].astype(np.float32)
        if seq.imu_quats is not None
        else np.zeros((imu_window, 4), np.float32)
    )
    odom_p = (
        seq.odom_poses[odom_i].astype(np.float32)
        if seq.odom_poses is not None
        else np.tile(np.eye(4, dtype=np.float32), (odom_window, 1, 1))
    )
    return (imu_s, imu_q), (odom_s, odom_p)
