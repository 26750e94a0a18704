"""Live serving (counterpart of `locus_tpu/live.py`): `LiveSession`, one
robot served one sweep at a time (the reference's LidarCallback), and
`MultiRobotSession`, several robots on one card in one batched step.

A LiveSession pulls scans from any iterator (a socket, a bag stream, the
native prefetcher), queues the sensor samples that arrive between scans,
runs the live step (one upload, one fetch), publishes through the
FixedRatePublisher, logs diagnostics, checkpoints periodically, and takes
loop-closure corrections back from a pose-graph backend
(`apply_loop_closure`). With `mesh=` it serves as one rank of a process
mesh with the map split over the mesh's "map" axis: every rank feeds the
same scans and samples, keeps its shard of the map, and returns the same
poses; closures re-anchor each shard where it lies, checkpoints are one
file a rank (`checkpoint.save_state_sharded`).
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from locus_tpu_torch import checkpoint as ckpt_mod
from locus_tpu_torch import diagnostics, localization, pipeline
from locus_tpu_torch.backend import CORRECTIONS_BUCKET
from locus_tpu_torch.config import LocusConfig, _update_dataclass
from locus_tpu_torch.ops.dispatch import resolve_device
from locus_tpu_torch.parallel.mesh import gather_state, shard_state
from locus_tpu_torch.publisher import FixedRatePublisher
from locus_tpu_torch.runner import (
    make_live_step,
    pack_scan,
    push_back_closure,
    replay_step,
    unpack_live_output,
)


def _drain(queue: list, n: int, payload_shape, eye: bool = False):
    """The newest n samples of a queue as a fixed-size window (older slots
    padded with -inf stamps), emptying the queue."""
    take = queue[-n:]
    del queue[:]
    pad = n - len(take)
    stamps = np.full((n,), -np.inf, np.float32)
    payload = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)) if eye else np.zeros((n,) + payload_shape, np.float32)
    for k, (s, v) in enumerate(take):
        stamps[pad + k] = s
        payload[pad + k] = v
    return stamps, payload


@dataclass
class LiveSession:
    """Stateful live-processing session of one robot on `device` (None: the
    CUDA device).

    feed_imu/feed_odom may be called between scans: the samples queue on
    the host and go to the device buffers with the next scan (the
    reference's AsyncSpinner contract)."""

    cfg: LocusConfig
    initial_pose: Optional[np.ndarray] = None
    publisher: Optional[FixedRatePublisher] = None
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 100
    imu_window: int = 16
    odom_window: int = 4
    # debug dumps (the reference publishes its query/reference/aligned
    # clouds, PointCloudOdometry.cc:123-134): the preprocessed scan and
    # the map as PCD every N scans
    debug_dump_dir: Optional[str] = None
    debug_dump_every: int = 20
    # Voxelise each scan on the host (the native library) at half the
    # current adaptive leaf before packing, as the reference's
    # CustomVoxelGrid nodelet does upstream of Locus
    # (custom_voxel_grid.cc:62-74); the device grid at the full leaf stays
    # decisive. The native library must build: this never falls back.
    host_prevoxelize: bool = False
    # map_sink(scan_count, map_state) on every cfg.map_publishment_meters-th
    # keyframe insertion (mapper_->PublishMap, Locus.cc:536-543)
    map_sink: Optional[Callable] = None
    # serve as one rank of a parallel.mesh.Mesh, the map split over its
    # "map" axis (the big-map live-localization deployment); every rank of
    # the mesh runs its own session on the same inputs
    mesh: Optional[object] = None
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._rstep, self._aux_len = make_live_step(self.cfg, self.imu_window, self.odom_window, mesh=self.mesh)
        pose = None if self.initial_pose is None else torch.as_tensor(np.asarray(self.initial_pose, np.float32))
        self.state = self._shard(pipeline.init_state_from_config(self.cfg, initial_pose=pose, device=self.device))
        self._imu_queue: list = []
        self._odom_queue: list = []
        self._scan_count = 0
        self._keyframe_count = 0
        self.diag = diagnostics.DiagnosticsLog(window_s=self.cfg.statistics_time_window)
        self.timer = diagnostics.StageTimer()

    # -- ingest ------------------------------------------------------------
    def feed_imu(self, stamp: float, quat_wxyz):
        self._imu_queue.append((float(stamp), np.asarray(quat_wxyz, np.float32)))

    def feed_odom(self, stamp: float, pose_4x4):
        self._odom_queue.append((float(stamp), np.asarray(pose_4x4, np.float32)))

    # -- the scan tick -----------------------------------------------------
    def process_scan(self, stamp: float, xyz: np.ndarray, valid=None):
        """Process one merged base-frame sweep; returns (pose (4,4) numpy,
        the StepOutput of numpy values). With
        cfg.b_enable_computation_time_profiling the StageTimer's
        "lidar_callback" spans the call up to the host fetch of the pose."""
        timing = (
            self.timer.time("lidar_callback")
            if self.cfg.b_enable_computation_time_profiling
            else contextlib.nullcontext()
        )
        with timing:
            xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
            valid_arr = np.ones(len(xyz), bool) if valid is None else np.asarray(valid, bool)
            if self.host_prevoxelize:
                from locus_tpu_torch import native

                leaf = float(self.state.voxel_leaf)
                xyz = native.voxel_downsample(xyz[valid_arr], max(leaf * 0.5, 1e-3), capacity=self.cfg.raw_scan_capacity)
                valid_arr = np.ones(len(xyz), bool)
            packed_xyz, mask = pack_scan(xyz, valid_arr, self.cfg.raw_scan_capacity)
            imu_s, imu_q = _drain(self._imu_queue, self.imu_window, (4,))
            odo_s, odo_p = _drain(self._odom_queue, self.odom_window, (4, 4), eye=True)
            # one upload of the scan with its mask, one of the aux vector,
            # and one fetch of the packed output
            xyzm = np.concatenate([packed_xyz, mask[:, None].astype(np.float32)], axis=1)
            aux = np.concatenate([
                np.asarray([stamp], np.float32),
                np.asarray([self._scan_count], np.int32).view(np.float32),   # bitwise
                imu_s, imu_q.ravel(), odo_s, odo_p.ravel(),
            ]).astype(np.float32)
            if aux.size != self._aux_len:
                raise ValueError(f"aux vector of {aux.size} values, the live step takes {self._aux_len}")
            self.state, packed = self._rstep(
                self.state, torch.from_numpy(xyzm).to(self.device), torch.from_numpy(aux).to(self.device)
            )
            out = unpack_live_output(packed.cpu().numpy())
            pose = out.pose

        self._scan_count += 1
        if out.keyframe_inserted:
            self._keyframe_count += 1
            if self.map_sink is not None and self._keyframe_count % max(self.cfg.map_publishment_meters, 1) == 0:
                self.map_sink(self._scan_count, self._whole_map())
        if self.publisher is not None:
            # fire the ticks due since the previous scan, then install the
            # new pose
            self.publisher.run_until(stamp)
            self.publisher.on_scan_pose(stamp, pose, out.covariance)
        self.diag.add(diagnostics.from_step_output(stamp, out, scan_count=self._scan_count))
        if self.checkpoint_path and self._scan_count % self.checkpoint_every == 0:
            if self.mesh is None:
                ckpt_mod.save_state(self.checkpoint_path, self.state)
            else:
                ckpt_mod.save_state_sharded(self.checkpoint_path, self.state, self.mesh, self.cfg.mapper.map_capacity)
        if self.debug_dump_dir and self._scan_count % self.debug_dump_every == 0:
            self._dump(packed_xyz[mask])
        return pose, out

    def _dump(self, scan_xyz: np.ndarray) -> None:
        from locus_tpu_torch.io import pcd
        from locus_tpu_torch.mapping.keyframe_map import snapshot_to_pcd

        whole = self._whole_map()
        if self.mesh is not None and self.mesh.rank != 0:
            return      # every rank gathers the map; rank 0 writes it
        os.makedirs(self.debug_dump_dir, exist_ok=True)
        pcd.write_pcd(os.path.join(self.debug_dump_dir, f"scan_{self._scan_count:06d}.pcd"), scan_xyz)
        snapshot_to_pcd(whole, os.path.join(self.debug_dump_dir, f"map_{self._scan_count:06d}.pcd"))

    def _shard(self, state):
        """This rank's shards of a whole state (the state itself unsharded)."""
        if self.mesh is None:
            return state
        return shard_state(self.mesh, state, self.cfg.mapper.map_capacity)

    def _whole_map(self):
        """The whole map (sharded: gathered from every rank, a collective)."""
        if self.mesh is None:
            return self.state.map
        return gather_state(self.mesh, self.state.map, self.cfg.mapper.map_capacity, at_map_root=True)

    # -- runtime reconfiguration -------------------------------------------
    # The reference changes parameters of a running system three ways:
    # dynamic_reconfigure on the filter nodelets, the change_leaf_size
    # topic (custom_voxel_grid.cc:62-74), and SetIntegratedEstimate
    # (PointCloudLocalization.h:114-117).

    # Fields that define the state's shapes or structure; changing them
    # would orphan the session's state.
    _STATE_SHAPE_FIELDS = (
        "scan_capacity",
        "raw_scan_capacity",
        ("mapper", "map_capacity"),
        ("mapper", "keyframe_capacity"),
        ("mapper", "num_shards"),
        ("mapper", "velocity_buffer_size"),
        ("mapper", "structure"),
        ("fusion", "imu_buffer_size"),
        ("fusion", "odometry_buffer_size"),
    )

    def reconfigure(self, overlay: dict):
        """Apply a nested parameter overlay to the running session
        (dynamic_reconfigure, e.g. {"filtering": {"box_max": [0.8, 0.8,
        0.8]}}), from the next scan on. Fields that define the state's
        shapes cannot change on a live session and raise ValueError."""
        new_cfg = _update_dataclass(self.cfg, overlay)
        for spec in self._STATE_SHAPE_FIELDS:
            path = spec if isinstance(spec, tuple) else (spec,)
            old, new = self.cfg, new_cfg
            for name in path:
                old, new = getattr(old, name), getattr(new, name)
            if old != new:
                raise ValueError(
                    f"reconfigure cannot change state-shaping field {'.'.join(path)!r} on a live session "
                    f"({old!r} -> {new!r}); start a new session (optionally resumed from a checkpoint)"
                )
        self.cfg = new_cfg
        self._rstep, self._aux_len = make_live_step(new_cfg, self.imu_window, self.odom_window, mesh=self.mesh)

    def set_voxel_leaf(self, leaf: float):
        """Set the input-voxelisation leaf in the device state (the
        change_leaf_size actuator); the adaptive law, if on, continues from
        it."""
        leaf = float(np.clip(leaf, self.cfg.voxel_leaf_min, self.cfg.voxel_leaf_max))
        self.state = self.state._replace(voxel_leaf=torch.tensor(leaf, dtype=torch.float32, device=self.device))

    def set_pose(self, pose_4x4):
        """External pose reset (SetIntegratedEstimate): overwrite the
        integrated estimate."""
        self.state = self.state._replace(loc=localization.set_integrated_estimate(self.state.loc, pose_4x4))

    def apply_loop_closure(self, corrected_pose, corrections):
        """Loop-closure push-back at serving granularity (the
        `run_sequence(backend=)` contract): the integrated estimate reset
        to `corrected_pose`, the owned map re-anchored by the per-keyframe
        `corrections` (K,4,4), padded with identities to a multiple of
        CORRECTIONS_BUCKET rows, and the keyframe policy's anchor moved.
        Sharded, each rank re-anchors its own shard (the corrections are
        replicated; no collective)."""
        corr = np.asarray(corrections, np.float32)
        pad = (-corr.shape[0]) % CORRECTIONS_BUCKET
        if pad:
            corr = np.concatenate([corr, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        self.state = push_back_closure(self.state, np.asarray(corrected_pose, np.float32), corr, self.cfg)

    def prewarm_loop_closure(self):
        """Run one closure push-back with an all-identity correction table
        before serving starts, so that the first real closure builds and
        allocates nothing new. A no-op on the session's pose and keyframe
        policy; the map's operand and chunk boxes are rebuilt from the
        same points."""
        ident = np.tile(np.eye(4, dtype=np.float32), (CORRECTIONS_BUCKET, 1, 1))
        saved_kf_pose = self.state.last_keyframe_pose
        self.apply_loop_closure(self.state.loc.integrated.cpu().numpy(), ident)
        self.state = self.state._replace(last_keyframe_pose=saved_kf_pose)

    # -- lifecycle ---------------------------------------------------------
    def resume(self, path: str):
        """Restore a checkpointed session (elastic recovery); the scan
        counter continues from the checkpoint's. Sharded, `path` is the
        prefix the session saved under, and each rank reads its own file."""
        template = self._shard(pipeline.init_state(self.cfg, device=self.device))
        if self.mesh is None:
            self.state = ckpt_mod.load_state(path, template)
        else:
            self.state = ckpt_mod.load_state_sharded(path, template, self.mesh, self.cfg.mapper.map_capacity)
        self._scan_count = int(self.state.stats.scan_count)

    def run(self, scan_source: Iterator, max_scans: Optional[int] = None):
        """Consume (stamp, xyz[, valid]) tuples until exhausted; returns the
        (T,4,4) poses."""
        poses = []
        for i, item in enumerate(scan_source):
            if max_scans is not None and i >= max_scans:
                break
            pose, _ = self.process_scan(item[0], item[1], item[2] if len(item) > 2 else None)
            poses.append(pose)
        return np.stack(poses) if poses else np.zeros((0, 4, 4))


@dataclass
class MultiRobotSession:
    """B independent robots served by ONE card: the reference runs one
    namespaced LOCUS instance per robot (locus.launch:24); here the robot
    axis is the batch of a single batched step. Each robot has its own
    full LocusState (pose, map, buffers); one batched step advances all of
    them per tick, its kernels launched once for all robots.

    All robots share one config (mixed configs need separate sessions),
    any single-card configuration of the step; each robot gets the poses a
    single replay of its own scans gives, bit for bit.
    There is no loop-closure push-back here (JAX's MultiRobotSession has
    none). `device=None` means the CUDA device."""

    cfg: LocusConfig
    num_robots: int = 2
    initial_poses: Optional[np.ndarray] = None   # (B,4,4)
    imu_window: int = 16
    odom_window: int = 4
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.states = pipeline.init_states(
            self.cfg, self.initial_poses, num_robots=self.num_robots, device=self.device
        )
        self._imu_queues = [[] for _ in range(self.num_robots)]
        self._odom_queues = [[] for _ in range(self.num_robots)]
        self._scan_count = 0

    def feed_imu(self, robot: int, stamp: float, quat_wxyz):
        self._imu_queues[robot].append((float(stamp), np.asarray(quat_wxyz, np.float32)))

    def feed_odom(self, robot: int, stamp: float, pose_4x4):
        self._odom_queues[robot].append((float(stamp), np.asarray(pose_4x4, np.float32)))

    def process_scans(self, stamps, xyzs, valids=None):
        """Advance every robot one sweep. stamps (B,), xyzs (B,P,3) or a
        list of per-robot (Pi,3) arrays. Returns (poses (B,4,4) numpy,
        the batched StepOutput).

        Robots whose lidar missed this tick can be fed their previous
        scan or an empty array (all-masked): the per-robot drop statistics
        and health cascade behave as in the single session."""
        B = self.num_robots
        cap = self.cfg.raw_scan_capacity
        xyz_b = np.zeros((B, cap, 3), np.float32)
        mask_b = np.zeros((B, cap), bool)
        for b in range(B):
            xyz = np.asarray(xyzs[b], np.float32).reshape(-1, 3)
            valid = np.ones(len(xyz), bool) if valids is None else np.asarray(valids[b], bool)
            xyz_b[b], mask_b[b] = pack_scan(xyz, valid, cap)

        imu_s = np.zeros((B, self.imu_window), np.float32)
        imu_q = np.zeros((B, self.imu_window, 4), np.float32)
        odo_s = np.zeros((B, self.odom_window), np.float32)
        odo_p = np.zeros((B, self.odom_window, 4, 4), np.float32)
        for b in range(B):
            imu_s[b], imu_q[b] = _drain(self._imu_queues[b], self.imu_window, (4,))
            odo_s[b], odo_p[b] = _drain(self._odom_queues[b], self.odom_window, (4, 4), eye=True)

        host = (
            xyz_b, mask_b, np.asarray(stamps, np.float32), imu_s, imu_q, odo_s, odo_p,
            np.full((B,), self._scan_count, np.int32),
        )
        args = (torch.as_tensor(a).to(self.device) for a in host)
        self.states, outs = replay_step(self.states, *args, cfg=self.cfg)
        self._scan_count += 1
        return outs.pose.cpu().numpy(), outs
