"""Driver `fleet`: a fleet of robots whose lidar odometry runs on one card,
one batched step a tick, replayed closed loop pass after pass from the same
fresh stacked state until the window ends.

Each robot's sweeps are made by `generate.make_sweeps` from the seed and
the robot's index, so every robot drives its own tunnel (its own pillars
and sway) and its loops take their own iteration counts. Robot r's tunnel
lies r x SPACING_M beside robot 0's, so no two robots are ever nearer than
SPACING_M less two sways, and a robot handed another robot's answer fails
the check's pose gap by metres, whatever the seed. The robots run in
lockstep: a tick is one sweep of each, through `runner.make_batched_replay`
(on the card one CUDA graph a tick, B4, B3 and batched B7 for all of them).
On the card the set-up refuses a program whose batched replay does not run
captured, at its first tick: the cell measures the captured batched step.

It reports `scans_per_s`: the robot-sweeps completed over all of the
window's seconds, the last pass included whole. A run's outputs are one
entry per robot per pass, each checked against the plain reference's
replay of that robot's sweeps.

Config keys: fleet.robots, the robots of the fleet. Traffic keys:
sweeps_per_pass (ticks a pass); trace_first and trace_sweeps, the ticks
[trace_first, trace_first + trace_sweeps) that a traced run traces in the
window's first pass, fenced at both ends.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from harness import generate, roofline, trace
from harness.program import Window, profiled, sequence, sync


SPACING_M = 20.0   # between two robots' tunnels, across them (a tunnel is 8 m wide; a sway 0.8 m)


def beside(sw: generate.Sweeps, dy: float) -> generate.Sweeps:
    """`sw` with its world moved `dy` metres along y: the poses and the
    odometry stream move, the clouds (in the lidar's frame) and the IMU's
    orientations do not."""
    gt, odom = sw.gt.copy(), sw.odom_poses.copy()
    gt[:, 1, 3] += dy
    odom[:, 1, 3] += dy
    return dataclasses.replace(sw, gt=gt, odom_poses=odom)


def traffic(conf: dict, mix: dict, seed: int, seconds: float, dev: torch.device) -> list:
    """One tunnel a robot: robot r's from the seed seed * robots + r, laid
    r x SPACING_M beside robot 0's."""
    robots = int(conf["fleet"]["robots"])
    return [beside(generate.make_sweeps(conf["sensor"], int(mix["sweeps_per_pass"]), seed * robots + r, dev,
                                        step=float(conf["robot"]["step_m"])), r * SPACING_M) for r in range(robots)]


def program_counters():
    """The program's counters (`ops.graph.read_counters`), or None where
    it keeps none."""
    from locus_tpu_torch.ops import graph

    read = getattr(graph, "read_counters", None)
    return None if read is None else read()


class Driver:
    def __init__(self, cfg, conf: dict, mix: dict, robots: list, dev: torch.device):
        from locus_tpu_torch import pipeline, runner

        ext = generate.extrinsics(conf["sensor"])
        if ext.shape[0] != 1 or not np.allclose(ext[0], np.eye(4)):
            raise ValueError("a fleet's robots carry one lidar each, in the base frame")
        self.cfg, self.dev = cfg, dev
        self.robots, self.n = len(robots), len(robots[0])
        a = int(mix["trace_first"])
        self.span = (a, min(a + int(mix["trace_sweeps"]), self.n))
        self.packed = runner.stack_packed([runner.pack_sequence(sequence(sw), cfg, device=dev) for sw in robots])
        self.states0 = pipeline.stack_states([
            pipeline.init_state_from_config(cfg, initial_pose=torch.as_tensor(sw.gt[0], dtype=torch.float32),
                                            device=dev) for sw in robots])
        self.replay = runner.make_batched_replay(cfg)

    def _segment(self, states, lo: int, hi: int, bufs, report=None):
        """Ticks [lo, hi) of a pass from `states`; returns the states."""
        part = {k: v[lo:hi] for k, v in self.packed.items()}
        states, (poses, _, sizes) = self.replay(states, part, report=report)
        bufs[0][lo:hi].copy_(poses)
        bufs[1][lo:hi].copy_(sizes)
        return states

    def _bufs(self):
        return (torch.empty((self.n, self.robots, 4, 4), device=self.dev),
                torch.empty((self.n, self.robots), dtype=torch.int32, device=self.dev))

    def _pass(self, traced: bool = False):
        """One pass from the fresh states: ((poses, sizes) on the device,
        and when traced (the profiler, the seconds) of the ticks of
        `self.span`, fenced at both ends)."""
        bufs = self._bufs()
        if not traced:
            self._segment(self.states0, 0, self.n, bufs)
            return bufs, None
        a, b = self.span
        states = self._segment(self.states0, 0, a, bufs) if a else self.states0
        sync(self.dev)
        with profiled(self.dev) as prof:
            t0 = time.perf_counter()
            states = self._segment(states, a, b, bufs)
            sync(self.dev)
            wall = time.perf_counter() - t0
        self._segment(states, b, self.n, bufs)
        return bufs, (prof, wall)

    def setup(self):
        """The warm pass: its first tick records the batched step's graph,
        and must have run captured on the card."""
        from locus_tpu_torch.metrics import RateReport

        report, bufs = RateReport(), self._bufs()
        states = self._segment(self.states0, 0, 1, bufs, report=report)
        if self.dev.type == "cuda" and not report.captured:
            raise RuntimeError("the batched replay ran its step eagerly: this cell measures the batched step "
                               "captured as one CUDA graph a tick")
        self._segment(states, 1, self.n, bufs)
        sync(self.dev)

    def window(self, seconds: float, traced: bool) -> Window:
        """Passes until `seconds` have gone by; a traced run traces the
        span of its first pass, and keeps the program's counters over the
        window's passes."""
        from locus_tpu_torch.ops import graph

        w = Window()
        passes, seg, outs = 0, None, []
        if hasattr(graph, "drop_counters"):
            graph.drop_counters()
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            bufs, got = self._pass(traced and passes == 0)
            outs.append(bufs)
            sync(self.dev)
            seg = seg or got
            passes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        w.elapsed_s = time.perf_counter() - t0
        w.sweeps = passes * self.n * self.robots
        w.values["scans_per_s"] = w.sweeps / w.elapsed_s
        counters = program_counters()
        if seg is not None:
            a, b = self.span
            w.trace = trace.record(seg[0], (b - a) * self.robots, seg[1], self.kernel_inputs(a, b))
            w.trace["ticks"] = b - a
            if counters is not None:
                w.trace["program_counters"] = counters
        for poses, sizes in outs:
            poses, sizes = poses.cpu().numpy().astype(np.float64), sizes.cpu().numpy()
            w.outputs += [(r, 0, poses[:, r], sizes[:, r]) for r in range(self.robots)]
        w.notes.append(f"robot-sweeps in the window: {w.sweeps} in {w.elapsed_s:.3f} s "
                       f"({passes} passes of {self.n} ticks, {self.robots} robots)")
        return w

    def kernel_inputs(self, a: int, b: int) -> list:
        """Per traced tick, what its kernel launches took: per member the
        valid points of the preprocessed scan, its leaf and B4's radius
        pairs, and the map's points before the tick; and the trips each
        GICP stage's loop ran (its slowest member's iterations). Read from
        one more pass, tick by tick, through the same entry (the passes
        are deterministic)."""
        rows = []
        states, prev = self.states0, [0] * self.robots
        scale = self.cfg.filtering.normals_radius_scale
        for i in range(b):
            outs = []
            states, _ = self.replay(states, {k: v[i:i + 1] for k, v in self.packed.items()}, outputs=outs)
            out = outs[0]
            if i >= a:
                scan = states.odom.reference
                members = []
                for r in range(self.robots):
                    leaf = float(out.voxel_leaf[r])
                    members.append({"num_points": int(out.num_points[r]), "leaf": leaf,
                                    "b4_pairs": roofline.radius_pairs(scan.xyz[r][scan.mask[r]], scale * leaf),
                                    "map_before": prev[r]})
                rows.append({"members": members,
                             "odom_loops": int(out.odom_iterations.max()), "loc_loops": int(out.loc_iterations.max()),
                             "odom_cap": self.cfg.odometry.iterations,
                             "loc_cap": self.cfg.localization.registration.iterations})
            prev = [int(x) for x in out.map_size.tolist()]
        return rows
