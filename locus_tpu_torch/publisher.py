"""Fixed-rate odometry output, upsampled by the odometry stream
(counterpart of `locus_tpu/publisher.py`; host-side numpy).

Re-design of the reference's PublishOdomOnTimer (Locus.cc:581-650): a
ros::Timer publishes the pose at odom_pub_rate (10 Hz) even between
lidar scans, advancing the last lidar pose with the delta of the
(visual/wheel) odometry stream since the scan stamp; duplicate
publishes are suppressed.

Host-side: the device produces per-scan poses; this module runs in the
host loop between device steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np


def _slerp_matrix(R0: np.ndarray, R1: np.ndarray, a: float) -> np.ndarray:
    """Rotation slerp via the axis-angle log of the relative rotation:
    R(a) = R0 exp(a log(R0^T R1))."""
    Rd = R0.T @ R1
    cos = np.clip((np.trace(Rd) - 1.0) * 0.5, -1.0, 1.0)
    ang = float(np.arccos(cos))
    if ang < 1e-9:
        return R0.copy()
    axis = np.array(
        [Rd[2, 1] - Rd[1, 2], Rd[0, 2] - Rd[2, 0], Rd[1, 0] - Rd[0, 1]]
    ) / (2.0 * np.sin(ang))
    th = a * ang
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    Ra = np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)
    return R0 @ Ra


@dataclass
class OdomSample:
    stamp: float
    pose: np.ndarray  # (4,4)


@dataclass
class FixedRatePublisher:
    rate_hz: float = 10.0
    sink: Optional[Callable[[float, np.ndarray, np.ndarray], None]] = None

    latest_scan_stamp: float = -1.0
    latest_scan_pose: Optional[np.ndarray] = None
    latest_covariance: Optional[np.ndarray] = None
    odom_buffer: List[OdomSample] = field(default_factory=list)
    last_published_stamp: float = -1.0
    published: List[Tuple[float, np.ndarray]] = field(default_factory=list)

    def on_scan_pose(self, stamp: float, pose: np.ndarray, covariance=None):
        """Called after each lidar step with the integrated pose."""
        self.latest_scan_stamp = float(stamp)
        self.latest_scan_pose = np.asarray(pose, np.float64)
        if covariance is not None:
            self.latest_covariance = np.asarray(covariance, np.float64)
        if self.last_published_stamp < 0:
            # anchor the timer at the first scan so subsequent run_until
            # calls fire the intermediate ticks
            self.last_published_stamp = float(stamp)

    def on_odom(self, stamp: float, pose: np.ndarray):
        """External odometry stream sample (the upsampling source)."""
        self.odom_buffer.append(OdomSample(float(stamp), np.asarray(pose, np.float64)))
        if len(self.odom_buffer) > 1000:
            self.odom_buffer = self.odom_buffer[-500:]

    def _odom_at(self, t: float) -> Optional[np.ndarray]:
        buf = self.odom_buffer
        if not buf:
            return None
        below = [s for s in buf if s.stamp <= t]
        above = [s for s in buf if s.stamp >= t]
        if not below or not above:
            return (below or above)[-1 if below else 0].pose
        s0 = below[-1]
        s1 = above[0]
        if s1.stamp <= s0.stamp + 1e-12:
            return s0.pose
        a = (t - s0.stamp) / (s1.stamp - s0.stamp)
        # translation lerp + rotation slerp, matching the reference's
        # tf2 time interpolation (Locus.cc:601-642 lookupTransform at
        # the in-between stamp)
        out = np.eye(4)
        out[:3, :3] = _slerp_matrix(s0.pose[:3, :3], s1.pose[:3, :3], a)
        out[:3, 3] = (1 - a) * s0.pose[:3, 3] + a * s1.pose[:3, 3]
        return out

    def tick(self, now: float):
        """Timer callback at rate_hz: publish the latest pose, upsampled
        with the odometry delta since the scan stamp when available."""
        if self.latest_scan_pose is None:
            return None
        if now <= self.last_published_stamp + 1e-9:
            return None  # dedup (b_have_published_odom_)
        pose = self.latest_scan_pose
        o_scan = self._odom_at(self.latest_scan_stamp)
        o_now = self._odom_at(now)
        if o_scan is not None and o_now is not None:
            delta = np.linalg.inv(o_scan) @ o_now
            pose = pose @ delta
        self.last_published_stamp = now
        self.published.append((now, pose))
        if self.sink is not None:
            self.sink(now, pose, self.latest_covariance)
        return pose

    def run_until(self, now: float):
        """Fire all timer ticks due up to `now`."""
        period = 1.0 / self.rate_hz
        start = self.last_published_stamp if self.last_published_stamp >= 0 else (
            self.latest_scan_stamp
        )
        if start < 0:
            return
        t = start + period
        while t <= now + 1e-9:
            self.tick(t)
            t += period
