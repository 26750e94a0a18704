"""The plain reference of the benchmark's deployments: LOCUS's lidar
odometry front end, one sweep after another, in plain PyTorch at float64
(or, for the control, at a lower precision).

It is written from the published semantics (Locus.cc, PointCloudOdometry.cc,
PointCloudLocalization.cc, gicp.hpp, point_cloud_merger, the body filter
and the keyframe sliding-window mapper) and from the configuration's own
parameters, and imports nothing of the program under test. Per sweep:

    merge the lidars into the base frame (extrinsics, z passthrough)
    -> body crop box -> voxel grid at the adaptive leaf (centroids in
       voxel-key order, strided when more voxels than the scan holds)
    -> radius PCA normals (radius = scale * leaf, at least 4 neighbours)
    -> the prior: IMU rotation delta (mode 1) or wheel-odometry delta (3)
    -> scan-to-scan GICP (plane-disk covariances, Gauss-Newton inner steps,
       the reference's scaled-delta convergence test, delta gating)
    -> map 1-NN at the predicted pose -> scan-to-submap GICP
    -> keyframe policy, novelty-gated insert into a ring map
    -> the map sliding window, gated on the robot being slow
    -> the next adaptive leaf.

Brute-force neighbour searches replace the program's pruned kernels, and
torch.linalg replaces its closed-form solves. Geometry is held in `dtype`;
the 3x3 and 6x6 eigen- and linear solves run in float32 at the least,
since PyTorch has no lower-precision solver.

`Reference.PATH` lists every key whose value chooses the path and that this
module follows rather than reads; a configuration that leaves that path is
refused with a ValueError naming the key. A reference of another path is a
sibling file that subclasses `Reference`, replaces `register` (both
registrations go through it) and the entries of `PATH` it covers, and
passes its class to `replay`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

PAD = 1.0e8


@dataclass
class RefState:
    odom_int: torch.Tensor
    odom_inc: torch.Tensor
    loc_int: torch.Tensor
    prev_xyz: torch.Tensor | None = None
    prev_n: torch.Tensor | None = None
    map_xyz: torch.Tensor | None = None
    map_n: torch.Tensor | None = None
    map_mask: torch.Tensor | None = None
    write_ptr: int = 0
    num_keyframes: int = 0
    last_refresh: torch.Tensor | None = None
    last_kf_pose: torch.Tensor | None = None
    leaf: float = 0.2
    prev_stamp: float = -1.0
    vel_t: list = field(default_factory=list)
    vel_r: list = field(default_factory=list)
    vel_ptr: int = 0
    prior_prev: torch.Tensor | None = None
    scan_count: int = 0


def _eye(dtype, device):
    return torch.eye(4, dtype=dtype, device=device)


def _solve_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse; a matrix that a low precision made singular gets
    its pseudo-inverse."""
    inv, info = torch.linalg.inv_ex(A)
    bad = info != 0
    if bool(bad.any()):
        inv[bad] = torch.linalg.pinv(A[bad])
    return inv


def _solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x, info = torch.linalg.solve_ex(H, g)
    return torch.linalg.pinv(H) @ g if int(info) != 0 or not bool(torch.isfinite(x).all()) else x


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt on the rotation block (x, then y, z = x cross y)."""
    x = T[:3, 0] / T[:3, 0].norm().clamp(min=1e-12)
    y = T[:3, 1] - torch.dot(x, T[:3, 1]) * x
    y = y / y.norm().clamp(min=1e-12)
    out = T.clone()
    out[:3, 0], out[:3, 1], out[:3, 2] = x, y, torch.linalg.cross(x, y)
    return out


def inverse(T: torch.Tensor) -> torch.Tensor:
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -(T[:3, :3].T @ T[:3, 3])
    return out


def rotation_angle(R: torch.Tensor) -> float:
    return math.acos(max(-1.0, min(1.0, (float(R[0, 0] + R[1, 1] + R[2, 2]) - 1.0) * 0.5)))


def euler_norm(R: torch.Tensor) -> float:
    roll = math.atan2(float(R[2, 1]), float(R[2, 2]))
    pitch = -math.asin(max(-1.0, min(1.0, float(R[2, 0]))))
    yaw = math.atan2(float(R[1, 0]), float(R[0, 0]))
    return math.sqrt(roll * roll + pitch * pitch + yaw * yaw)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, 3, 3)."""
    z = torch.zeros_like(v[:, 0])
    return torch.stack([
        torch.stack([z, -v[:, 2], v[:, 1]], -1),
        torch.stack([v[:, 2], z, -v[:, 0]], -1),
        torch.stack([-v[:, 1], v[:, 0], z], -1),
    ], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[v, w] -> 4x4 (Rodrigues rotation, V-matrix translation)."""
    v, w = xi[:3], xi[3:]
    th2 = float(torch.dot(w, w))
    th = math.sqrt(th2)
    W = skew(w[None])[0]
    if th2 < 1e-10:
        a, b, c = 1.0 - th2 / 6.0, 0.5 - th2 / 24.0, 1.0 / 6.0 - th2 / 120.0
    else:
        a, b = math.sin(th) / th, (1.0 - math.cos(th)) / th2
        c = (1.0 - a) / th2
    I3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = I3 + a * W + b * (W @ W)
    T[:3, 3] = (I3 + b * W + c * (W @ W)) @ v
    return T


def quat_to_matrix(q) -> torch.Tensor:
    w, x, y, z = (float(c) for c in q)
    n = math.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return torch.tensor([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=torch.float64)


def quat_delta(q0, q1):
    """conj(q0) * q1, (w, x, y, z)."""
    w0, x0, y0, z0 = (float(c) for c in q0)
    x0, y0, z0 = -x0, -y0, -z0
    w1, x1, y1, z1 = (float(c) for c in q1)
    return (
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
    )


def nearest(query: torch.Tensor, target: torch.Tensor, radius: float, budget: int = 1 << 26):
    """Brute-force 1-NN of each query row among the target rows: (d2, j),
    d2 = +inf where the nearest lies farther than `radius` or there is no
    target. Differences, not the expanded |q|^2 - 2 q.t + |t|^2, in blocks
    of queries that keep each block's differences under `budget` values."""
    n = query.shape[0]
    d2 = torch.full((n,), math.inf, dtype=query.dtype, device=query.device)
    j = torch.zeros((n,), dtype=torch.int64, device=query.device)
    if target.shape[0] == 0 or n == 0:
        return d2, j
    block = max(1, budget // (3 * target.shape[0]))
    for a in range(0, n, block):
        q = query[a:a + block]
        m, i = ((q[:, None, :] - target[None, :, :]) ** 2).sum(-1).min(dim=1)
        d2[a:a + block] = torch.where(m <= radius * radius, m, torch.full_like(m, math.inf))
        j[a:a + block] = i
    return d2, j


def voxel_grid(xyz: torch.Tensor, leaf: float, capacity: int) -> torch.Tensor:
    """pcl::VoxelGrid centroids, in (kx, ky, kz) order; with more occupied
    voxels than `capacity`, voxels floor(i * n / capacity) (a float32
    stride, as the configuration's scan budget is spread over the scene)."""
    if xyz.shape[0] == 0:
        return xyz
    keys = torch.floor(xyz / leaf).to(torch.int64)
    uniq, inv = torch.unique(keys, dim=0, return_inverse=True)
    acc = torch.zeros((uniq.shape[0], 3), dtype=torch.float64, device=xyz.device)
    acc.index_add_(0, inv, xyz.to(torch.float64))
    cnt = torch.zeros((uniq.shape[0],), dtype=torch.float64, device=xyz.device)
    cnt.index_add_(0, inv, torch.ones_like(inv, dtype=torch.float64))
    cent = (acc / cnt[:, None]).to(xyz.dtype)
    nv = cent.shape[0]
    if nv > capacity:
        pick = (torch.arange(capacity, dtype=torch.float32, device=xyz.device)
                * torch.tensor(nv / capacity, dtype=torch.float32)).to(torch.int64)
        cent = cent[pick.clamp(max=nv - 1)]
    return cent


def radius_normals(xyz: torch.Tensor, radius: float, min_neighbors: int = 4, block: int = 1024) -> torch.Tensor:
    """Smallest-eigenvector normals of each point's neighbours within
    `radius` (itself included), turned towards the sensor; zero where fewer
    than `min_neighbors`."""
    n = xyz.shape[0]
    out = torch.zeros_like(xyz)
    sd = _solve_dtype(xyz.dtype)
    for a in range(0, n, block):
        q = xyz[a:a + block]
        w = (((q[:, None, :] - xyz[None, :, :]) ** 2).sum(-1) <= radius * radius).to(xyz.dtype)
        cnt = w.sum(1)
        mean = (w @ xyz) / cnt.clamp(min=1)[:, None]
        c = xyz[None, :, :] - mean[:, None, :]
        cov = torch.einsum("qn,qni,qnj->qij", w, c, c) / cnt.clamp(min=1)[:, None, None]
        _, vec = torch.linalg.eigh(torch.nan_to_num(cov.to(sd), nan=0.0, posinf=0.0, neginf=0.0))
        nrm = vec[:, :, 0].to(xyz.dtype)
        sign = torch.where((nrm * (-q)).sum(-1) < 0, -1.0, 1.0).to(xyz.dtype)
        out[a:a + block] = torch.where((cnt >= min_neighbors)[:, None], nrm * sign[:, None], torch.zeros_like(nrm))
    return out


def gicp(src, src_n, tgt, tgt_n, guess, reg: dict):
    """Plane-disk GICP of `src` onto `tgt` from `guess`: per outer
    iteration the 1-NN pairs within corr_dist, M = (C_tgt + R C_src R^T)^-1
    with C = I - (1 - eps) n n^T (+1e-6 on the diagonal), then
    `inner_iterations` Gauss-Newton steps on the left-multiplied SE(3)
    increment; converged when max |dT| scaled by 1/rotation_epsilon (3x3
    block) and 1/tf_epsilon (elsewhere) falls under 1. Returns the
    source -> target transform, guess included."""
    dt, dev = src.dtype, src.device
    sd = _solve_dtype(dt)
    src0 = src @ guess[:3, :3].T + guess[:3, 3]
    n0 = src_n @ guess[:3, :3].T
    k = 1.0 - reg["gicp_epsilon"]
    I3 = torch.eye(3, dtype=dt, device=dev)
    scale = torch.full((4, 4), 1.0 / reg["tf_epsilon"], dtype=dt, device=dev)
    scale[:3, :3] = 1.0 / reg["rotation_epsilon"]
    T = _eye(dt, dev)
    for _ in range(reg["iterations"]):
        p = src0 @ T[:3, :3].T + T[:3, 3]
        d2, j = nearest(p, tgt, reg["corr_dist"])
        w = torch.isfinite(d2).to(dt)
        q = tgt[j] if tgt.shape[0] else p
        a = n0 @ T[:3, :3].T
        b = tgt_n[j] if tgt.shape[0] else torch.zeros_like(a)
        A = 2.0 * I3 - k * (a[:, :, None] * a[:, None, :] + b[:, :, None] * b[:, None, :])
        M = _inv(A.to(sd) + 1e-6 * torch.eye(3, dtype=sd, device=dev)).to(dt) * w[:, None, None]
        T_new = T
        for _ in range(reg["inner_iterations"]):
            pc = src0 @ T_new[:3, :3].T + T_new[:3, 3]
            J = torch.cat([I3.expand(pc.shape[0], 3, 3), -skew(pc)], dim=2)      # (N, 3, 6)
            MJ = M @ J
            H = torch.einsum("nki,nkj->ij", J, MJ)
            g = torch.einsum("nki,nk->i", MJ, pc - q)
            ridge = reg["levenberg_lambda"] * max(float(torch.trace(H)) / 6.0, 1.0) * 1e-6
            dx = -_solve(H.to(sd) + ridge * torch.eye(6, dtype=sd, device=dev), g.to(sd)).to(dt)
            T_new = se3_exp(dx) @ T_new
        T_new = orthonormalize(T_new)
        delta = float(((T - T_new).abs() * scale).max())
        T = T_new
        if delta < 1.0:
            break
    return T @ guess


def gate(T: torch.Tensor, reg: dict) -> bool:
    return float(T[:3, 3].norm()) <= reg["max_translation"] and euler_norm(T[:3, :3]) <= reg["max_rotation"]


def _stated(locus: dict, key: str):
    node = locus
    for part in key.split("."):
        if not isinstance(node, dict) or part not in node:
            raise ValueError(f"locus.{key} is not stated: the reference follows only the values it knows")
        node = node[part]
    return node


def _same(value, allowed) -> bool:
    return any(type(value) is type(a) and value == a for a in allowed)


class Reference:
    """One robot's front end. `locus` is the configuration's "locus" block
    (every parameter on this path, stated in the file); `extrinsics` (L, 4,
    4) the lidar -> base transforms."""

    # Each key whose value chooses the path, and the values this reference
    # follows. Where the program's fusion in mode 3 integrates the
    # interpolated odometry, the reference still takes the nearest sample:
    # `__init__` refuses that pair as well.
    PATH = {
        "odometry.registration_method": ("gicp",),
        "odometry.covariance_mode": ("normals",),
        "odometry.recompute_covariances": (False,),
        "odometry.transform_thresholding": (True,),
        "localization.registration.registration_method": ("gicp",),
        "localization.registration.covariance_mode": ("normals",),
        "localization.registration.recompute_covariances": (False,),
        "localization.registration.transform_thresholding": (True,),
        "filtering.normals_method": ("radius",),
        "filtering.extract_features": (False,),
        "filtering.random_filter": (False,),
        "filtering.grid_filter": (False,),
        "filtering.outlier_filter": (False,),
        "filtering.radius_filter": (False,),
        "mapper.structure": ("ring",),
        "mapper.keyframe_at_map_resolution": (False,),
        "fusion.data_integration_mode": (1, 3),
        "fusion.b_convert_imu_to_base_link_frame": (False,),
        "merger.b_use_random_filter": (False,),
        "merger.b_use_radius_filter": (False,),
        "b_monitor_space": (False,),
        "b_is_flat_ground_assumption": (False,),
        "b_add_keyframes_enabled": (True,),
        "b_run_with_gt_point_cloud": (False,),
    }

    def __init__(self, locus: dict, extrinsics, initial_pose, device, dtype=torch.float64):
        for key, allowed in self.PATH.items():
            value = _stated(locus, key)
            if not _same(value, allowed):
                raise ValueError(f"locus.{key}={value!r}: this reference follows only {allowed}")
        mode = _stated(locus, "fusion.data_integration_mode")
        if mode == 3 and _stated(locus, "fusion.b_integrate_interpolated_odom"):
            raise ValueError("locus.fusion.b_integrate_interpolated_odom=True with data_integration_mode 3: "
                             "this reference takes the odometry sample nearest the sweep")
        self.c, self.dtype, self.dev = locus, dtype, torch.device(device)
        self.ext = torch.as_tensor(extrinsics, dtype=dtype, device=self.dev)
        P0 = torch.as_tensor(initial_pose, dtype=dtype, device=self.dev)
        m = locus["mapper"]
        self.s = RefState(
            odom_int=P0.clone(), odom_inc=_eye(dtype, self.dev), loc_int=P0.clone(),
            map_xyz=torch.full((m["map_capacity"], 3), PAD, dtype=dtype, device=self.dev),
            map_n=torch.zeros((m["map_capacity"], 3), dtype=dtype, device=self.dev),
            map_mask=torch.zeros((m["map_capacity"],), dtype=torch.bool, device=self.dev),
            last_refresh=torch.zeros(3, dtype=dtype, device=self.dev), last_kf_pose=P0.clone(),
            leaf=float(locus["filtering"]["grid_res"]),
            vel_t=[0.0] * m["velocity_buffer_size"], vel_r=[0.0] * m["velocity_buffer_size"],
        )

    # -- input stages ------------------------------------------------------
    def merge(self, clouds, valids) -> torch.Tensor:
        """Lidar clouds (L, R, 3) in their frames -> the valid base-frame
        points, lidar by lidar, at most raw_scan_capacity of them."""
        mg = self.c["merger"]
        parts = []
        for l in range(clouds.shape[0]):
            p = clouds[l][valids[l]].to(self.dtype)
            p = p @ self.ext[l, :3, :3].T + self.ext[l, :3, 3]
            if mg["b_use_passthrough"]:
                p = p[(p[:, 2] >= -mg["passthrough_limit"]) & (p[:, 2] <= mg["passthrough_limit"])]
            parts.append(p)
        return torch.cat(parts)[: self.c["raw_scan_capacity"]]

    def prior(self, stamp: float, imu, odom) -> torch.Tensor:
        """The registration's warm start: the IMU's rotation delta since the
        last sweep (mode 1) or the wheel odometry's delta (mode 3), each from
        the sample nearest the sweep's stamp within max_buffer_staleness
        among those received; identity on the first."""
        f = self.c["fusion"]
        mode = f["data_integration_mode"]
        stamps, rows = odom if mode == 3 else imu
        sel = np.nonzero(stamps <= stamp + 1e-9)[0]
        if sel.size == 0:
            return _eye(self.dtype, self.dev)
        i = int(sel[np.argmin(np.abs(stamps[sel] - stamp))])
        if abs(float(stamps[i]) - stamp) > f["max_buffer_staleness"]:
            return _eye(self.dtype, self.dev)
        cur = rows[i]
        prev, self.s.prior_prev = self.s.prior_prev, cur
        if prev is None:
            return _eye(self.dtype, self.dev)
        out = torch.eye(4, dtype=torch.float64)
        if mode == 3:
            out = inverse(torch.as_tensor(prev, dtype=torch.float64)) @ torch.as_tensor(cur, dtype=torch.float64)
        else:
            out[:3, :3] = quat_to_matrix(quat_delta(prev, cur))
        return out.to(self.dtype).to(self.dev)

    def register(self, src, src_n, tgt, tgt_n, guess, reg: dict) -> torch.Tensor:
        """The source -> target transform, guess included: scan-to-scan
        (`reg` the odometry's) and scan-to-submap (the localization's) both
        come here. This reference's registration is plane-disk GICP."""
        return gicp(src, src_n, tgt, tgt_n, guess, reg)

    # -- one sweep -------------------------------------------------------------
    def step(self, raw: torch.Tensor, stamp: float, imu, odom):
        """Process one merged sweep (valid base-frame points); returns
        (pose (4, 4), map size)."""
        c, s, dt, dev = self.c, self.s, self.dtype, self.dev
        flt, m = c["filtering"], c["mapper"]
        pts = raw.to(dt)
        if flt["body_filter"]:
            lo = torch.tensor(flt["box_min"], dtype=dt, device=dev)
            hi = torch.tensor(flt["box_max"], dtype=dt, device=dev)
            pts = pts[~((pts >= lo) & (pts <= hi)).all(-1)]
        leaf = s.leaf
        xyz = voxel_grid(pts, leaf, c["scan_capacity"])
        num = xyz.shape[0]
        nrm = radius_normals(xyz, flt["normals_radius_scale"] * leaf)
        if c["b_adaptive_input_voxelization"]:
            prop = min(max(leaf * num / c["points_to_process_in_callback"], c["voxel_leaf_min"]), c["voxel_leaf_max"])
            if abs(leaf - prop) > 0.01:
                s.leaf = prop

        guess = self.prior(stamp, imu, odom)
        # scan-to-scan
        performed = s.prev_xyz is not None
        if performed:
            T = self.register(xyz, nrm, s.prev_xyz, s.prev_n, guess, c["odometry"])
            if gate(T, c["odometry"]):
                s.odom_inc = T
                s.odom_int = orthonormalize(s.odom_int @ T)
        s.prev_xyz, s.prev_n = xyz, nrm

        # scan-to-submap
        inc = s.odom_inc.clone()
        predicted = s.loc_int @ inc
        fixed = xyz @ predicted[:3, :3].T + predicted[:3, 3]
        mm = s.map_mask
        d2_all, j = nearest(fixed, s.map_xyz[mm], m["ann_search_radius"])
        have_map = s.num_keyframes > 0
        if have_map:
            hit = torch.isfinite(d2_all)
            nb = s.map_xyz[mm][j[hit]]
            nb_n = s.map_n[mm][j[hit]]
            Pinv = inverse(predicted)
            nb_s = nb @ Pinv[:3, :3].T + Pinv[:3, 3]
            nb_ns = nb_n @ Pinv[:3, :3].T
            lreg = c["localization"]["registration"]
            T2 = self.register(xyz, nrm, nb_s, nb_ns, _eye(dt, dev), lreg)
            if gate(T2, lreg):
                inc = inc @ T2
            s.loc_int = orthonormalize(s.loc_int @ inc)
            pose = s.loc_int.clone()
        else:
            pose = s.odom_int.clone() if performed else s.loc_int.clone()

        # velocities (the sliding window's gate)
        first = s.prev_stamp < 0
        dts = max(stamp - s.prev_stamp, 1e-3)
        vb = len(s.vel_t)
        s.vel_t[s.vel_ptr % vb] = 0.0 if first else float(inc[:3, 3].norm()) / dts
        s.vel_r[s.vel_ptr % vb] = 0.0 if first else rotation_angle(inc[:3, :3]) / dts
        s.vel_ptr += 1
        s.prev_stamp = stamp

        # keyframe policy and the novelty-gated ring insert
        dk = inverse(s.last_kf_pose) @ pose
        moved = (float(dk[:3, 3].norm()) > c["translation_threshold_closed_space_kf"]
                 or rotation_angle(dk[:3, :3]) > c["rotation_threshold_closed_space_kf"])
        if s.scan_count == 0 or moved:
            novel = d2_all > m["map_voxel_leaf"] ** 2
            kx = xyz[novel] @ pose[:3, :3].T + pose[:3, 3]
            kn = nrm[novel] @ pose[:3, :3].T
            cap, k = m["map_capacity"], c["scan_capacity"]
            ptr = 0 if s.write_ptr > cap - k else s.write_ptr
            n_new = kx.shape[0]
            s.map_xyz[ptr:ptr + n_new] = kx
            s.map_n[ptr:ptr + n_new] = kn
            s.map_mask[ptr:ptr + n_new] = True
            s.write_ptr = ptr + n_new
            s.num_keyframes += 1
            s.last_kf_pose = pose.clone()

        if m["b_enable_msw"]:
            pos = pose[:3, 3]
            slow = (sum(s.vel_t) / vb < m["translational_velocity_threshold"]
                    and sum(s.vel_r) / vb < m["rotational_velocity_threshold"])
            if float((pos - s.last_refresh).norm()) > m["translation_threshold_msw"] and slow and s.num_keyframes > 0:
                inside = ((s.map_xyz - pos).abs() <= m["box_filter_size"] * 0.5).all(-1)
                s.map_mask &= inside
                s.last_refresh = pos.clone()
        s.scan_count += 1
        return pose, int(s.map_mask.sum())


def replay(locus: dict, extrinsics, sweeps_xyz, sweeps_valid, stamps, gt0, imu, odom, device,
           dtype=torch.float64, count=None, cls=Reference):
    """The reference over the first `count` sweeps (default: all): poses
    (S, 4, 4) float64 and map sizes (S,) on the host. sweeps_xyz (S, L, R,
    3) and sweeps_valid (S, L, R) are the lidars' own clouds; imu and odom
    are (stamps, rows) pairs of host arrays. `cls` is the front end it
    builds: `Reference` or a subclass of it."""
    ref = cls(locus, extrinsics, gt0, device, dtype)
    n = len(stamps) if count is None else count
    poses, sizes = [], []
    for i in range(n):
        raw = ref.merge(sweeps_xyz[i].to(device), sweeps_valid[i].to(device))
        pose, size = ref.step(raw, float(stamps[i]), imu, odom)
        poses.append(pose.to(torch.float64).cpu())
        sizes.append(size)
    return torch.stack(poses).numpy(), sizes
