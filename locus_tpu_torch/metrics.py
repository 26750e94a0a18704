"""Trajectory evaluation (ATE) and rate/latency reporting.

A numpy copy of `locus_tpu/metrics.py`, kept in the port so that it runs
without JAX.

The reference's accuracy metric is ATE vs. the nebula-odometry-dataset
ground truth (README.md:110-160, external evo-style eval), and its
latency instrumentation is rostopic hz/delay + per-stage duration topics
(tmuxp configs; scripts/profiler.py). This module provides both natively.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid alignment est->gt for (N,3) trajectories.
    Returns (R, t, s)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    cov = G.T @ E / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / (E ** 2).sum() * est.shape[0]) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True
) -> float:
    """Absolute trajectory error RMSE over (N,3) position sequences."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    assert est.shape == gt.shape
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
):
    """Relative pose error over (N,4,4) pose sequences: per-step
    translational and rotational drift."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = est.shape[0] - delta
    terr, rerr = [], []
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(terr)))), float(
        np.sqrt(np.mean(np.square(rerr)))
    )


class RateReport:
    """rostopic hz/delay analog: collects per-scan wall latencies and
    reports rate/percentiles (scripts/profiler.py parity). `captured`:
    whether the replay that filled it ran its step as one CUDA graph a
    scan (`runner.make_replay_step`) or eagerly."""

    def __init__(self):
        self.durations = []
        self.captured = False

    def add(self, seconds: float):
        self.durations.append(seconds)

    def summary(self) -> dict:
        d = np.asarray(self.durations)
        if d.size == 0:
            return {}
        return {
            "captured": self.captured,
            "count": int(d.size),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p95_s": float(np.percentile(d, 95)),
            "max_s": float(d.max()),
            "rate_hz": float(1.0 / d.mean()),
        }
