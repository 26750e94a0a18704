"""Procedural point-cloud fixtures and a simulated multi-ring lidar.

A numpy copy of `locus_tpu/io/synthetic.py`, kept in the port so that it
runs without JAX.

Mirrors the reference's test fixtures (GenerateCubic / GenerateHollowCubic
/ GeneratePlane — point_cloud_odometry/test/test_point_cloud_odometry.cpp:23-124,
point_cloud_localization/test/test_point_cloud_localization.cpp:26-47) and
adds a VLP-16-style raycast simulator over a procedurally generated world,
which serves as the dataset-replay stand-in for the nebula rosbags
(not shipped with the reference checkout).
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Simple fixtures (numpy; converted by callers)
# ---------------------------------------------------------------------------

def hollow_cube(step: float = 0.1, side: float = 1.0, jitter: float = 0.0, seed: int = 0):
    """Points on the 6 faces of a cube, with outward face normals.

    Returns (xyz, normals) float32 arrays.
    """
    rng = np.random.default_rng(seed)
    lin = np.arange(0.0, side + 1e-6, step, dtype=np.float32)
    u, v = np.meshgrid(lin, lin, indexing="ij")
    u = u.ravel()
    v = v.ravel()
    zeros = np.zeros_like(u)
    ones = np.full_like(u, side)
    faces = [
        (np.stack([u, v, zeros], 1), [0, 0, -1]),
        (np.stack([u, v, ones], 1), [0, 0, 1]),
        (np.stack([u, zeros, v], 1), [0, -1, 0]),
        (np.stack([u, ones, v], 1), [0, 1, 0]),
        (np.stack([zeros, u, v], 1), [-1, 0, 0]),
        (np.stack([ones, u, v], 1), [1, 0, 0]),
    ]
    xyz = np.concatenate([f[0] for f in faces]).astype(np.float32)
    nrm = np.concatenate(
        [np.tile(np.asarray(n, np.float32), (f.shape[0], 1)) for f, n in faces]
    )
    if jitter > 0:
        xyz = xyz + rng.normal(scale=jitter, size=xyz.shape).astype(np.float32)
    return xyz, nrm


def plane(
    nx: int = 20, ny: int = 20, step: float = 0.1, z: float = 0.0
):
    """Axis-aligned plane grid with +z normals (GeneratePlane analog)."""
    xs = np.arange(nx, dtype=np.float32) * step
    ys = np.arange(ny, dtype=np.float32) * step
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    xyz = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z, np.float32)], 1)
    nrm = np.tile(np.asarray([0, 0, 1], np.float32), (xyz.shape[0], 1))
    return xyz, nrm


# ---------------------------------------------------------------------------
# Simulated lidar world
# ---------------------------------------------------------------------------

class BoxWorld:
    """A world of axis-aligned boxes (rooms, tunnels, pillars) supporting
    ray casting — the synthetic stand-in for subterranean environments.

    Boxes are (min_xyz, max_xyz) and rays hit their *interior* surfaces if
    `inside=True` (a tunnel/room shell) or exterior if False (obstacle).
    """

    def __init__(self):
        self.shells = []     # list[(lo, hi)] rays bounce inside
        self.obstacles = []  # list[(lo, hi)] rays hit outside

    def add_shell(self, lo, hi):
        self.shells.append((np.asarray(lo, np.float64), np.asarray(hi, np.float64)))
        return self

    def add_obstacle(self, lo, hi):
        self.obstacles.append((np.asarray(lo, np.float64), np.asarray(hi, np.float64)))
        return self

    @staticmethod
    def urban(length: float = 80.0):
        """Corridor with side rooms and doorways (urban-circuit analog)."""
        w = BoxWorld()
        w.add_shell([-3.0, -3.0, -1.5], [length + 3.0, 3.0, 2.5])
        rng = np.random.default_rng(21)
        x = 6.0
        side = 1.0
        while x < length:
            # side room connected by an implied doorway (overlapping shells)
            depth = rng.uniform(3.0, 6.0)
            w.add_shell(
                [x, side * 2.9, -1.5], [x + 4.0, side * (2.9 + depth), 2.5]
            ) if side > 0 else w.add_shell(
                [x, -(2.9 + depth), -1.5], [x + 4.0, -2.9, 2.5]
            )
            # furniture-ish obstacles in the corridor
            cx = x + rng.uniform(0.5, 3.0)
            cy = rng.uniform(-1.8, 1.8)
            w.add_obstacle([cx - 0.25, cy - 0.25, -1.5], [cx + 0.25, cy + 0.25, 0.0])
            side = -side
            x += 8.0
        return w

    @staticmethod
    def cave(length: float = 80.0, seed: int = 5):
        """Winding irregular passage assembled from offset overlapping
        shells (cave-circuit analog: no long straight planes)."""
        w = BoxWorld()
        rng = np.random.default_rng(seed)
        x, y = -4.0, 0.0
        while x < length:
            seg = rng.uniform(6.0, 10.0)
            hw = rng.uniform(2.0, 3.5)      # half width varies
            hh = rng.uniform(1.2, 2.2)
            y2 = y + rng.uniform(-2.5, 2.5)
            lo_y, hi_y = min(y, y2) - hw, max(y, y2) + hw
            w.add_shell([x - 1.0, lo_y, -hh], [x + seg + 1.0, hi_y, hh])
            # rubble
            for _ in range(2):
                cx = x + rng.uniform(0, seg)
                cy = rng.uniform(lo_y + 0.5, hi_y - 0.5)
                s = rng.uniform(0.2, 0.5)
                w.add_obstacle([cx - s, cy - s, -hh], [cx + s, cy + s, -hh + rng.uniform(0.3, 1.0)])
            x += seg
            y = y2
        return w

    @staticmethod
    def default_tunnel(length: float = 120.0):
        """A long tunnel with side rooms and pillars (subT-flavored)."""
        w = BoxWorld()
        w.add_shell([-5.0, -4.0, -1.5], [length + 5.0, 4.0, 3.5])
        rng = np.random.default_rng(7)
        x = 8.0
        while x < length:
            # pillars alternate sides
            side = 1.0 if (int(x) // 8) % 2 == 0 else -1.0
            cx = x + rng.uniform(-1, 1)
            cy = side * rng.uniform(1.0, 2.5)
            w.add_obstacle([cx - 0.4, cy - 0.4, -1.5], [cx + 0.4, cy + 0.4, 1.5])
            x += 8.0
        return w

    # -- ray casting --------------------------------------------------------
    def raycast(self, origins: np.ndarray, dirs: np.ndarray, max_range: float = 100.0):
        """Batch ray cast: origins (N,3), dirs (N,3) unit. Returns
        (hits (N,3) float32, valid (N,) bool).

        Shells form a UNION of free space: a ray keeps going while its
        current exit point lies inside ANY other shell, and only the
        union boundary is a wall. (The r1-r4 version took the nearest
        single-shell exit, which planted *position-dependent phantom
        walls* inside every shell overlap — consistent-looking geometry
        per scan but different between scans, which read as up to the
        overlap extent of registration error. Harmless for the thin
        doorway overlaps of the urban world; catastrophic for the 8x8 m
        corner overlaps of circuit_world — 13 m/100 m drift, the
        'responsible defect' of the first ENDURANCE run.)

        Assumes every ray origin lies inside free space (inside at least
        one shell and outside every obstacle): an origin outside all
        shells sees max_range on every ray, and one inside an obstacle
        sees nothing of it."""
        n = origins.shape[0]
        inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)

        def slab(lo, hi):
            t0 = (lo[None, :] - origins) * inv
            t1 = (hi[None, :] - origins) * inv
            tmin = np.minimum(t0, t1)
            tmax = np.maximum(t0, t1)
            enter = tmin.max(axis=1)
            exit_ = tmax.min(axis=1)
            return enter, exit_

        # precompute per-shell (enter, exit) along each ray
        shell_ee = [slab(lo, hi) for lo, hi in self.shells]

        # union exit: advance t to the farthest exit among shells whose
        # interval contains the current t; iterate until fixed point
        # (<= #shells rounds — each round leaves at least one shell
        # permanently behind).
        t_exit = np.zeros(n, dtype=np.float64)
        eps = 1e-9
        for _ in range(max(len(self.shells), 1)):
            new_t = t_exit
            for enter, exit_ in shell_ee:
                covers = (enter <= t_exit + eps) & (exit_ > t_exit + eps)
                new_t = np.where(covers, np.maximum(new_t, exit_), new_t)
            if np.all(new_t <= t_exit + eps):
                break
            t_exit = new_t
        inside_any = t_exit > eps
        t_best = np.where(inside_any, t_exit, max_range)
        t_best = np.minimum(t_best, max_range)

        for lo, hi in self.obstacles:
            enter, exit_ = slab(lo, hi)
            hit = (enter > 1e-9) & (enter < exit_)
            t = np.where(hit, enter, np.inf)
            t_best = np.minimum(t_best, t)

        valid = t_best < max_range - 1e-6
        hits = origins + dirs * t_best[:, None]
        return hits.astype(np.float32), valid


def vlp16_directions(azimuth_steps: int = 900):
    """VLP-16 ray directions: 16 rings at elevations -15..+15 deg, `azimuth_steps`
    azimuth bins (sensor_description/urdf/sensors/VLP-16.urdf.xacro)."""
    elev = np.deg2rad(np.linspace(-15.0, 15.0, 16))
    azim = np.linspace(0.0, 2 * np.pi, azimuth_steps, endpoint=False)
    az, el = np.meshgrid(azim, elev, indexing="ij")
    d = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    )
    return d.reshape(-1, 3), az.reshape(-1), el.reshape(-1)


def simulate_scan(
    world: BoxWorld,
    pose: np.ndarray,
    azimuth_steps: int = 900,
    max_range: float = 60.0,
    noise: float = 0.01,
    seed: int = 0,
):
    """Simulate one VLP-16 sweep from a 4x4 world-frame pose.

    Returns (xyz_sensor (M,3) float32, valid mask): points in the SENSOR
    frame (like a real driver), Gaussian range noise applied.
    """
    rng = np.random.default_rng(seed)
    dirs_s, _, _ = vlp16_directions(azimuth_steps)
    R = pose[:3, :3].astype(np.float64)
    t = pose[:3, 3].astype(np.float64)
    dirs_w = dirs_s @ R.T
    origins = np.broadcast_to(t, dirs_w.shape).copy()
    hits_w, valid = world.raycast(origins, dirs_w, max_range=max_range)
    # back to sensor frame
    pts_s = (hits_w.astype(np.float64) - t) @ R
    if noise > 0:
        rr = np.linalg.norm(pts_s, axis=1, keepdims=True)
        pts_s = pts_s * (1.0 + rng.normal(scale=noise, size=(pts_s.shape[0], 1)) / np.maximum(rr, 1.0))
    return pts_s.astype(np.float32), valid


def circuit_world(
    side: float = 125.0,
    half_width: float = 4.0,
    pillar_every: float = 8.0,
    room_every: float = 30.0,
    seed: int = 11,
) -> BoxWorld:
    """A closed square tunnel circuit (side x side perimeter corridor,
    2*half_width wide) with pillars and side rooms — the kilometer-class
    endurance world (the multi-lap analog of the reference's full SubT
    dataset replays, tmuxp_config/run_nebula_odometry_dataset/). Pillars
    every ~pillar_every m give longitudinal observability in the
    straights (a bare corridor is degenerate along its axis); they sit
    1.6-3.2 m off the centerline so the robot path stays clear."""
    w = BoxWorld()
    hw = half_width
    z0, z1 = -1.5, 3.0
    # four corridor shells; interiors overlap at the corners
    w.add_shell([-hw, -hw, z0], [side + hw, hw, z1])            # bottom
    w.add_shell([side - hw, -hw, z0], [side + hw, side + hw, z1])  # right
    w.add_shell([-hw, side - hw, z0], [side + hw, side + hw, z1])  # top
    w.add_shell([-hw, -hw, z0], [hw, side + hw, z1])            # left
    rng = np.random.default_rng(seed)

    # corridor centerlines: (start, along-axis, lateral-axis)
    corridors = [
        (np.array([0.0, 0.0]), np.array([1.0, 0.0]), np.array([0.0, 1.0])),
        (np.array([side, 0.0]), np.array([0.0, 1.0]), np.array([-1.0, 0.0])),
        (np.array([side, side]), np.array([-1.0, 0.0]), np.array([0.0, -1.0])),
        (np.array([0.0, side]), np.array([0.0, -1.0]), np.array([1.0, 0.0])),
    ]
    for start, along, lat in corridors:
        d = pillar_every * 0.8
        side_sign = 1.0
        while d < side - pillar_every * 0.5:
            # lateral offset scales with corridor width; the path stays
            # clear by >= 0.45*hw on any width
            off = side_sign * rng.uniform(0.45 * hw, max(hw - 0.6, 0.5 * hw))
            c = start + along * d + lat * off
            s = rng.uniform(0.25, 0.45)
            w.add_obstacle([c[0] - s, c[1] - s, z0], [c[0] + s, c[1] + s, z1 - 1.5])
            side_sign = -side_sign
            d += pillar_every * rng.uniform(0.8, 1.2)
        # side rooms (alcoves) off the outer wall
        d = room_every
        while d < side - room_every * 0.5:
            c = start + along * d
            depth = rng.uniform(2.5, 5.0)
            lo = c - along * 2.0 - lat * (hw - 0.2 + depth)
            hi = c + along * 2.0 - lat * (hw - 0.2 - 0.0)
            w.add_shell(
                [min(lo[0], hi[0]), min(lo[1], hi[1]), z0],
                [max(lo[0], hi[0]), max(lo[1], hi[1]), z1],
            )
            d += room_every
    return w


def make_circuit_trajectory(
    num_poses: int,
    side: float = 125.0,
    corner_radius: float = 3.0,
    laps: int = 2,
) -> np.ndarray:
    """Multi-lap trajectory around the circuit_world perimeter: rounded-
    square path at the corridor centerline, heading tangent. Returns
    (num_poses, 4, 4); consecutive laps retrace the same path, so every
    lap-2+ keyframe is a loop-closure revisit of lap 1."""
    rc = corner_radius
    if side <= 2.0 * rc:
        raise ValueError(
            f"circuit side {side:.2f} <= 2*corner_radius {2 * rc:.2f}: "
            "the rounded-square path would self-intersect (negative "
            "straights); shrink corner_radius or grow the circuit "
            "(dataset.circuit_geometry clamps this automatically)"
        )
    L = side - 2.0 * rc
    qc = np.pi * rc / 2.0
    P = 4.0 * (L + qc)
    s_all = np.mod(np.arange(num_poses) * (laps * P / num_poses), P)
    starts = [
        (rc, 0.0, 0.0),
        (side, rc, np.pi / 2),
        (side - rc, side, np.pi),
        (0.0, side - rc, -np.pi / 2),
    ]
    corners = [
        ((side - rc, rc), -np.pi / 2),
        ((side - rc, side - rc), 0.0),
        ((rc, side - rc), np.pi / 2),
        ((rc, rc), np.pi),
    ]
    poses = np.zeros((num_poses, 4, 4))
    for i in range(num_poses):
        si = float(s_all[i])
        k = 0
        while True:
            if si < L:
                x0, y0, hd = starts[k]
                x = x0 + si * np.cos(hd)
                y = y0 + si * np.sin(hd)
                yaw = hd
                break
            si -= L
            if si < qc:
                (cx, cy), a0 = corners[k]
                a = a0 + si / rc
                x = cx + rc * np.cos(a)
                y = cy + rc * np.sin(a)
                yaw = a + np.pi / 2
                break
            si -= qc
            k += 1
        c, sn = np.cos(yaw), np.sin(yaw)
        poses[i] = np.eye(4)
        poses[i, :3, :3] = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1.0]])
        poses[i, :3, 3] = [x, y, 0.0]
    return poses


def make_loop_trajectory(num_poses: int, radius: float = 8.0) -> np.ndarray:
    """Closed circular loop (for loop-closure / pose-graph tests):
    (num_poses, 4, 4), heading tangent to the circle, returning to the
    start."""
    poses = np.zeros((num_poses, 4, 4))
    for i in range(num_poses):
        th = 2 * np.pi * i / num_poses
        c, s = np.cos(th), np.sin(th)
        poses[i] = np.eye(4)
        # position on circle; heading tangent (d/dth)
        poses[i, :3, 3] = [radius * np.sin(th), radius * (1 - np.cos(th)), 0.0]
        poses[i, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return poses


def make_trajectory(num_poses: int, step: float = 0.35, seed: int = 3) -> np.ndarray:
    """Forward motion along +x with sinusoidal lateral sway and yaw —
    (num_poses, 4, 4) ground-truth poses."""
    poses = np.zeros((num_poses, 4, 4))
    x = np.arange(num_poses) * step
    y = 0.8 * np.sin(x * 0.12)
    yaw = np.gradient(y, x if num_poses > 1 else 1.0) if num_poses > 1 else np.zeros(1)
    yaw = np.arctan(yaw)
    for i in range(num_poses):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        poses[i] = np.eye(4)
        poses[i, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        poses[i, :3, 3] = [x[i], y[i], 0.0]
    return poses
