#!/usr/bin/env python3
"""Fault injection on the port's sequences (tools/simulate_sensor_drops.py
on locus_tpu_torch, the reference's scripts/simulate_sensors_drops.py
analog): writes a copy of an io.dataset.Sequence with IMU and odometry
outage windows, the data-level test of the sensor-health cascade. Numpy
only; runs on no device.

    python tools/torch_simulate_sensor_drops.py in.npz out.npz \\
        --odom-gaps 2.0:4.0 8.0:9.5 --imu-gaps 3.0:3.5

Imports neither JAX nor the JAX package.
"""
import argparse

import _pathsetup  # noqa: F401
import numpy as np


def drop_windows(stamps, arrays, gaps):
    """`stamps` and each of `arrays` without the samples stamped inside any
    (lo, hi) of `gaps`, both ends included."""
    if stamps is None:
        return stamps, arrays
    keep = np.ones(stamps.shape[0], bool)
    for lo, hi in gaps:
        keep &= ~((stamps >= lo) & (stamps <= hi))
    return stamps[keep], [a[keep] for a in arrays]


def parse_gaps(items):
    """["lo:hi", ...] -> [(lo, hi), ...] in seconds."""
    out = []
    for it in items or []:
        lo, hi = it.split(":")
        out.append((float(lo), float(hi)))
    return out


def simulate_drops(seq, odom_gaps, imu_gaps):
    """`seq` with the odometry samples in `odom_gaps` and the IMU samples in
    `imu_gaps` removed (in place; returned)."""
    if seq.odom_stamps is not None and odom_gaps:
        seq.odom_stamps, (seq.odom_poses,) = drop_windows(seq.odom_stamps, [seq.odom_poses], odom_gaps)
    if seq.imu_stamps is not None and imu_gaps:
        seq.imu_stamps, (seq.imu_quats,) = drop_windows(seq.imu_stamps, [seq.imu_quats], imu_gaps)
    return seq


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--odom-gaps", nargs="*", default=[])
    ap.add_argument("--imu-gaps", nargs="*", default=[])
    args = ap.parse_args()
    from locus_tpu_torch.io.dataset import Sequence

    seq = simulate_drops(Sequence.load(args.input), parse_gaps(args.odom_gaps), parse_gaps(args.imu_gaps))
    seq.save(args.output)
    print(
        f"wrote {args.output}: odom {0 if seq.odom_stamps is None else len(seq.odom_stamps)} "
        f"samples, imu {0 if seq.imu_stamps is None else len(seq.imu_stamps)} samples"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
