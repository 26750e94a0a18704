"""Live serving of several robots on one card (counterpart of
`locus_tpu/live.py::MultiRobotSession`). The single-robot `LiveSession`
is ROADMAP A14."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from locus_tpu_torch import pipeline
from locus_tpu_torch.config import LocusConfig
from locus_tpu_torch.ops.dispatch import resolve_device
from locus_tpu_torch.runner import pack_scan, replay_step


@dataclass
class MultiRobotSession:
    """B independent robots served by ONE card: the reference runs one
    namespaced LOCUS instance per robot (locus.launch:24); here the robot
    axis is the batch of a single batched step. Each robot has its own
    full LocusState (pose, map, buffers); one batched step advances all of
    them per tick, its kernels launched once for all robots.

    All robots share one config (mixed configs need separate sessions).
    `device=None` means the CUDA device."""

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

    def _drain(self, queue, n, payload_shape, eye=False):
        """The newest n samples of a queue as a fixed-size window (older
        slots padded with -inf stamps), emptying the queue."""
        take = queue[-n:]
        del queue[: len(queue)]
        pad = n - len(take)
        stamps = np.full((n,), -np.inf, np.float32)
        payload = (
            np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
            if eye
            else np.zeros((n,) + payload_shape, np.float32)
        )
        for k, (s, v) in enumerate(take):
            stamps[pad + k] = s
            payload[pad + k] = v
        return stamps, payload

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
            imu_s[b], imu_q[b] = self._drain(self._imu_queues[b], self.imu_window, (4,))
            odo_s[b], odo_p[b] = self._drain(self._odom_queues[b], self.odom_window, (4, 4), eye=True)

        host = (
            xyz_b, mask_b, np.asarray(stamps, np.float32), imu_s, imu_q, odo_s, odo_p,
            np.full((B,), self._scan_count, np.int32),
        )
        args = (torch.as_tensor(a).to(self.device) for a in host)
        self.states, outs = replay_step(self.states, *args, cfg=self.cfg)
        self._scan_count += 1
        return outs.pose.cpu().numpy(), outs
