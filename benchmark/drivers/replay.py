"""Driver `replay`: closed-loop replay of one robot's pass, pass after pass
from the same fresh state, until the window ends.

One lidar goes through `runner.make_scan_replay` (the captured step on the
card); several go sweep by sweep through `merger.observe`, `health` and
`merge`, then `runner.make_replay_step`. The fencing is that of
`tools/torch_bench.py`: a fresh state a pass, the device synchronised
before and after it. It reports `scans_per_s`: every sweep completed over
all of the window's seconds, the last pass included whole.

Traffic keys: sweeps_per_pass; trace_first and trace_sweeps, the sweeps
[trace_first, trace_first + trace_sweeps) that a traced run traces in the
window's first pass, fenced at both ends.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import generate, roofline, trace
from harness.program import Window, one_robot, profiled, sequence, sync


def traffic(conf: dict, mix: dict, seed: int, seconds: float, dev: torch.device) -> list:
    return one_robot(conf, mix, seed, dev)


class Driver:
    def __init__(self, cfg, conf: dict, mix: dict, robots: list, dev: torch.device):
        from locus_tpu_torch import pipeline

        (sweeps,) = robots
        self.cfg, self.mix, self.sw, self.dev = cfg, mix, sweeps, dev
        self.ext = generate.extrinsics(conf["sensor"])
        self.timeout = float(conf["sensor"]["lidar_timeout_s"])
        self.n = len(sweeps)
        a = int(mix["trace_first"])
        self.span = (a, min(a + int(mix["trace_sweeps"]), self.n))
        self.state0 = pipeline.init_state_from_config(
            cfg, initial_pose=torch.as_tensor(sweeps.gt[0], dtype=torch.float32), device=dev)
        self.merged = self.ext.shape[0] > 1
        if self.merged:
            self._setup_merged()
        else:
            if not np.allclose(self.ext[0], np.eye(4)):
                raise ValueError("a one-lidar rig takes its sweeps in the base frame: give it the identity")
            from locus_tpu_torch import runner

            self.packed = runner.pack_sequence(sequence(sweeps), cfg, device=dev)
            self.replay = runner.make_scan_replay(cfg)

    def _setup_merged(self):
        from locus_tpu_torch import merger, runner
        from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud
        from locus_tpu_torch.io.dataset import sensor_windows_for_scan

        cfg, sw, dev = self.cfg, self.sw, self.dev
        L, R = sw.xyz.shape[1], sw.xyz.shape[2]
        slot = cfg.raw_scan_capacity // L
        if slot < R:
            raise ValueError(f"raw_scan_capacity {cfg.raw_scan_capacity} holds {slot} points a lidar, a sweep has {R}")
        xyz = torch.full((self.n, L, slot, 3), PAD_COORD, dtype=torch.float32, device=dev)
        mask = torch.zeros((self.n, L, slot), dtype=torch.bool, device=dev)
        xyz[:, :, :R] = torch.where(sw.valid[..., None], sw.xyz, PAD_COORD)
        mask[:, :, :R] = sw.valid
        zeros3 = torch.zeros((slot, 3), device=dev)
        zeros1 = torch.zeros((slot,), device=dev)
        self.clouds = [[PointCloud(xyz[i, l], zeros3, zeros1, mask[i, l]) for l in range(L)] for i in range(self.n)]
        self.ext_t = [torch.as_tensor(e, dtype=torch.float32, device=dev) for e in self.ext]
        seq = sequence(sw)
        wins = [sensor_windows_for_scan(seq, i) for i in range(self.n)]
        self.win = [torch.as_tensor(np.stack(a)).to(dev) for a in
                    ([w[0][0] for w in wins], [w[0][1] for w in wins], [w[1][0] for w in wins], [w[1][1] for w in wins])]
        self.stamps = torch.as_tensor(sw.stamps, dtype=torch.float32).to(dev)
        self.seq_ids = torch.arange(self.n, dtype=torch.int32, device=dev)
        self.mstate0 = merger.init_state(L, device=dev)
        self.rstep = runner.make_replay_step(cfg, dev)

    def _merged_sweeps(self, state, lo: int, hi: int, poses, sizes):
        from locus_tpu_torch import merger

        cfg, mstate = self.cfg, self.mstate
        for i in range(lo, hi):
            now = float(self.sw.stamps[i])
            with record_function("benchmark.merger"):
                for k in range(len(self.ext_t)):
                    mstate = merger.observe(mstate, k, now)
                alive = merger.health(mstate, now, timeout=self.timeout)
                merged = merger.merge(self.clouds[i], self.ext_t, alive, cfg.merger, capacity=cfg.raw_scan_capacity)
            state, out = self.rstep(state, merged.xyz, merged.mask, self.stamps[i], self.win[0][i], self.win[1][i],
                                    self.win[2][i], self.win[3][i], self.seq_ids[i])
            poses[i].copy_(out.pose)
            sizes[i].copy_(out.map_size)
        self.mstate = mstate
        return state, out

    def _segment(self, state, lo: int, hi: int, bufs):
        """Sweeps [lo, hi) of a pass from `state`; returns the state."""
        if self.merged:
            return self._merged_sweeps(state, lo, hi, *bufs)[0]
        part = {k: v[lo:hi] for k, v in self.packed.items()}
        state, (poses, _, sizes) = self.replay(state, part)
        bufs[0][lo:hi].copy_(poses)
        bufs[1][lo:hi].copy_(sizes)
        return state

    def _bufs(self):
        self.mstate = self.mstate0 if self.merged else None
        return (torch.empty((self.n, 4, 4), device=self.dev), torch.empty((self.n,), dtype=torch.int32, device=self.dev))

    def _pass(self, traced: bool = False):
        """One pass from the fresh state: ((poses, sizes) on the device, and
        when traced (the profiler, the seconds) of the sweeps of
        `self.span`, fenced at both ends)."""
        bufs = self._bufs()
        if not traced:
            self._segment(self.state0, 0, self.n, bufs)
            return bufs, None
        a, b = self.span
        state = self._segment(self.state0, 0, a, bufs) if a else self.state0
        sync(self.dev)
        with profiled(self.dev) as prof:
            t0 = time.perf_counter()
            state = self._segment(state, a, b, bufs)
            sync(self.dev)
            wall = time.perf_counter() - t0
        self._segment(state, b, self.n, bufs)
        return bufs, (prof, wall)

    def setup(self):
        self._pass()      # records the captured step's graph and warms every shape
        sync(self.dev)

    def window(self, seconds: float, traced: bool) -> Window:
        """Passes until `seconds` have gone by; a traced run traces the
        span of its first pass."""
        w = Window()
        passes, seg = 0, None
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            bufs, got = self._pass(traced and passes == 0)
            w.outputs.append((0, 0) + bufs)
            sync(self.dev)
            seg = seg or got
            passes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        w.elapsed_s = time.perf_counter() - t0
        w.sweeps = passes * self.n
        w.values["scans_per_s"] = w.sweeps / w.elapsed_s
        if seg is not None:
            a, b = self.span
            w.trace = trace.record(seg[0], b - a, seg[1], self.kernel_inputs(a, b))
        w.outputs = [(r, s, p.cpu().numpy().astype(np.float64), z.cpu().numpy()) for r, s, p, z in w.outputs]
        w.notes.append(f"sweeps in the window: {w.sweeps} in {w.elapsed_s:.3f} s ({passes} passes)")
        return w

    def kernel_inputs(self, a: int, b: int) -> list:
        """Per traced sweep, what its kernel launches took: the valid points
        of the preprocessed scan, the leaf and B1's radius pairs, the map's
        points before the sweep, and the outer iterations of both GICP
        stages. Read from one more pass, sweep by sweep, through the same
        entry (the passes are deterministic)."""
        rows = []
        bufs = self._bufs()
        state, prev_size = self.state0, 0
        for i in range(b):
            if self.merged:
                state, out = self._merged_sweeps(state, i, i + 1, *bufs)
            else:
                outs = []
                state, _ = self.replay(state, {k: v[i:i + 1] for k, v in self.packed.items()}, outputs=outs)
                out = outs[0]
            if i >= a:
                scan = state.odom.reference
                xyz = scan.xyz[scan.mask]
                leaf = float(out.voxel_leaf)
                radius = self.cfg.filtering.normals_radius_scale * leaf
                rows.append({"num_points": int(out.num_points), "leaf": leaf,
                             "b1_pairs": roofline.radius_pairs(xyz, radius), "map_before": prev_size,
                             "odom_iterations": int(out.odom_iterations), "loc_iterations": int(out.loc_iterations),
                             "odom_cap": self.cfg.odometry.iterations,
                             "loc_cap": self.cfg.localization.registration.iterations})
            prev_size = int(out.map_size)
        return rows
