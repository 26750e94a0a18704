"""What every driver shares: the program's configuration built from a
configuration file, the traffic made from the seed, device fences, the
profiler, and the record a window returns.

A driver is `benchmark/drivers/<name>.py`, named by a traffic file's
`driver` key, and holds

- `traffic(conf, mix, seed, seconds, dev)`: the robots' sweeps, a list of
  `generate.Sweeps`, one per robot, made from the seed;
- `Driver(cfg, conf, mix, robots, dev)` with `setup()`, which builds and
  warms the program on this cell's shapes, and `window(seconds, traced)`,
  which measures and returns a `Window`.

Nothing here is the yardstick's arithmetic: that is in `trace`,
`roofline`, `check` and the readers under `benchmark/metrics/`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile

from harness import generate


def build_config(locus: dict):
    """The program's configuration: its defaults with the configuration
    file's "locus" tree laid over them; a key the program does not have
    is an error."""
    from locus_tpu_torch.config import LocusConfig

    return _overlay(LocusConfig(), locus, "")


def _overlay(obj, data: dict, path: str):
    names = {f.name for f in dataclasses.fields(obj)}
    changes = {}
    for k, v in data.items():
        if k not in names:
            raise KeyError(f"{path}{k} is no field of the program's configuration")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur):
            changes[k] = _overlay(cur, v, f"{path}{k}.")
        else:
            changes[k] = tuple(v) if isinstance(cur, tuple) else v
    return dataclasses.replace(obj, **changes)


def one_robot(conf: dict, mix: dict, seed: int, dev: torch.device) -> list:
    """One robot's pass of the mix's `sweeps_per_pass` sweeps, driven at
    the configuration's `robot.step_m` a sweep, from `seed`."""
    return [generate.make_sweeps(conf["sensor"], int(mix["sweeps_per_pass"]), seed, dev,
                                 step=float(conf["robot"]["step_m"]))]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profiled(dev: torch.device):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    return profile(activities=acts)


def sequence(sw: generate.Sweeps):
    """The first lidar's sweeps and the sensor streams as the program's
    replay input (its `Sequence`)."""
    from locus_tpu_torch.io.dataset import Sequence

    return Sequence(
        scans=sw.xyz[:, 0].cpu().numpy(), scan_valid=sw.valid[:, 0].cpu().numpy(), stamps=sw.stamps,
        gt_poses=sw.gt, imu_stamps=sw.imu_stamps, imu_quats=sw.imu_quats, odom_stamps=sw.odom_stamps,
        odom_poses=sw.odom_poses,
    )


@dataclasses.dataclass
class Window:
    """What one window produced.

    values: the end-to-end metrics the driver measured, by their names in
    BENCHMARK.json (`setup_s` is the harness's); sweeps and elapsed_s: the
    sweeps completed over all robots and the window's seconds; outputs:
    per run of the program (robot, first sweep, poses (n, 4, 4) float64,
    map sizes (n,)) on the host; trace: the traced segment's record
    (`trace.record`) or None; notes: lines for standard error."""

    values: dict = dataclasses.field(default_factory=dict)
    sweeps: int = 0
    elapsed_s: float = 0.0
    outputs: list = dataclasses.field(default_factory=list)
    trace: dict | None = None
    notes: list = dataclasses.field(default_factory=list)
