"""The comparison that decides `correct`: every sweep the program
processed, of every robot, against the plain reference's replay of the
same sweeps. The reference is the one the configuration names by its
`reference` key (default DEFAULT_REFERENCE): `benchmark/reference/<name>.py`.

Numbers compared, over every sweep of every pass:
- pose_gap_m: the largest distance between the program's and the reference's
  position. It grows along a pass: both drift along the tunnel, each in
  its own way, so it holds the trajectory to the reference only loosely;
- step_gap_m and step_rot_rad: the largest gap between the program's and the
  reference's motion from the previous sweep (P_{i-1}^-1 P_i): translation
  distance and rotation angle. Drift does not accumulate in them;
- map_size_gap: the median over the sweeps of |program's map points -
  reference's| / the reference's (after the sweep's insert and
  sliding-window refresh). A median, since a keyframe taken one sweep
  apart on the two sides parts the sizes by a keyframe's points (up to a
  quarter of the map) for that one sweep.
Each has a limit in the cell's `benchmark/limits/<cell>.json`; a cell with
no limits file cannot come out correct. A sweep fails where its pose or
step gap passes its limit, or is not finite.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

DEFAULT_REFERENCE = "locus_ref"
NUMBERS = ("pose_gap_m", "step_gap_m", "step_rot_rad", "map_size_gap")


def _angle(R: np.ndarray) -> np.ndarray:
    return np.arccos(np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0))


def _steps(P: np.ndarray) -> np.ndarray:
    """P_{i-1}^-1 P_i of consecutive poses: (n - 1, 4, 4)."""
    inv = np.tile(np.eye(4), (P.shape[0] - 1, 1, 1))
    Rt = np.swapaxes(P[:-1, :3, :3], 1, 2)
    inv[:, :3, :3] = Rt
    inv[:, :3, 3] = -np.einsum("nij,nj->ni", Rt, P[:-1, :3, 3])
    return inv @ P[1:]


def gaps(outputs, refs) -> tuple[dict, np.ndarray]:
    """The compared numbers, and per checked sweep its (pose gap, step
    gap, step rotation gap) as rows of an (n, 3) array (a run's first
    sweep has no step: 0). `outputs`: (robot, first sweep, poses, map
    sizes) per run of the program; `refs`: per robot the reference's
    (poses, map sizes) over all its sweeps."""
    rows, size_gaps = [], []
    for robot, first, poses, sizes in outputs:
        n = poses.shape[0]
        ref = refs[robot][0][first:first + n]
        dt = np.linalg.norm(poses[:, :3, 3] - ref[:, :3, 3], axis=1)
        sp, sr = _steps(poses), _steps(ref)
        st = np.concatenate([[0.0], np.linalg.norm(sp[:, :3, 3] - sr[:, :3, 3], axis=1)])
        srot = np.concatenate([[0.0], _angle(np.einsum("nji,njk->nik", sr[:, :3, :3], sp[:, :3, :3]))])
        rows.append(np.stack([dt, st, srot], axis=1))
        rs = np.asarray(refs[robot][1], np.float64)[first:first + n]
        size_gaps.append(np.abs(np.asarray(sizes, np.float64) - rs) / np.maximum(rs, 1.0))
    per = np.concatenate(rows) if rows else np.zeros((0, 3))
    worst = {"pose_gap_m": per[:, 0], "step_gap_m": per[:, 1], "step_rot_rad": per[:, 2]}
    worst = {k: float(v.max()) if v.size and np.isfinite(v).all() else math.inf for k, v in worst.items()}
    size_gap = float(np.median(np.concatenate(size_gaps))) if size_gaps else math.inf
    worst["map_size_gap"] = size_gap if math.isfinite(size_gap) else math.inf
    return worst, per


def reference(root: Path, conf: dict, robots: list, dev, dtype=torch.float64) -> list:
    """The configuration's plain reference's (poses, map sizes) over each
    robot's sweeps, its geometry at `dtype` (the control asks for a lower
    precision than float64). A reference refuses a configuration whose path
    it does not follow, with a ValueError naming the key."""
    from harness import cells, generate

    ref = cells.reference(root, conf.get("reference", DEFAULT_REFERENCE))
    return [ref.replay(conf["locus"], generate.extrinsics(conf["sensor"]), sw.xyz, sw.valid, sw.stamps, sw.gt[0],
                       (sw.imu_stamps, sw.imu_quats), (sw.odom_stamps, sw.odom_poses), dev, dtype=dtype)
            for sw in robots]


def load_limits(root: Path, cell: str) -> dict | None:
    path = root / "benchmark" / "limits" / f"{cell}.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())["limits"]


def judge(numbers: dict, per: np.ndarray, limits: dict | None) -> tuple[bool, int, dict]:
    """(correct, failed sweeps, {number: {value, limit}}). A sweep fails
    where its pose or rotation gap passes its limit, or is not finite."""
    lim = limits or {}
    shown = {k: {"value": numbers[k], "limit": lim.get(k)} for k in NUMBERS}
    if limits is None:
        return False, int(per.shape[0]), shown
    bad = (~np.isfinite(per).all(axis=1) | (per[:, 0] > lim["pose_gap_m"]) | (per[:, 1] > lim["step_gap_m"])
           | (per[:, 2] > lim["step_rot_rad"]))
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= lim[k] for k in NUMBERS)
    return ok and not bad.any(), int(bad.sum()), shown
