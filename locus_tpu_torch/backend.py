"""Host-side pose-graph backend loop (counterpart of `locus_tpu/backend.py`).

The reference integrates with an external SLAM backend (LAMP) only
through `SetIntegratedEstimate` (PointCloudLocalization.h:114-117): the
backend watches keyframes, optimises a pose graph and overwrites the
front-end pose after a loop closure. This is that backend, on
`parallel/posegraph.py`:

- it collects keyframe poses and the sequential odometry factors;
- it finds loop-closure candidates by revisit distance (keyframes near in
  space, far in sequence) and verifies each by GICP of the stored
  keyframe clouds (kernel B2 at SCAN_BT on the card);
- it optimises the graph (Gauss-Newton with PCG) and returns the
  corrected pose and the per-keyframe corrections that re-anchor the map.

The graph is padded to POSE_BUCKET poses and FACTOR_BUCKET factors: the
padded poses are unconnected (zero update) and the padded factors masked,
so a padded graph solves to the same poses as the bare one. The JAX
package pads so that its compiled solver sees few shapes; the port keeps
the padding so that both solve the same systems.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from locus_tpu_torch.config import RegistrationConfig
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.ops.dispatch import resolve_device
from locus_tpu_torch.parallel import posegraph as pg
from locus_tpu_torch.registration.gicp import gicp_register

# Rows of the correction table handed to the map's reanchor (padded with
# identities, which leave a keyframe in place).
CORRECTIONS_BUCKET = 1024

# Shape buckets of the graph optimize() solves (see the module docstring).
POSE_BUCKET = 256
FACTOR_BUCKET = 512


@dataclass
class Keyframe:
    index: int
    stamp: float
    pose: np.ndarray                    # (4,4) front-end pose at insertion
    cloud: Optional[PointCloud] = None  # the downsampled scan (sensor frame)


def _padded(a: np.ndarray, n: int, fill: np.ndarray) -> np.ndarray:
    """`a` with copies of `fill` appended up to n rows."""
    pad = n - a.shape[0]
    return np.concatenate([a, np.broadcast_to(fill, (pad,) + fill.shape)]) if pad else a


@dataclass
class PoseGraphBackend:
    """Keyframes and factors live on the host; the keyframe clouds, the
    verification GICP and the graph solve on `device` (None: the CUDA
    device)."""

    loop_distance: float = 3.0        # spatial gate for candidates [m]
    min_index_gap: int = 10           # temporal gate [keyframes]
    loop_fitness_max: float = 0.05    # GICP fitness acceptance
    registration: RegistrationConfig = field(
        default_factory=lambda: RegistrationConfig(corr_dist=0.5, iterations=30)
    )
    device: Optional[str] = None

    keyframes: List[Keyframe] = field(default_factory=list)
    factors: List[tuple] = field(default_factory=list)  # (i, j, T_ij (4,4), info scale)
    loops_found: int = 0
    solves: int = 0                   # graph solves optimize() has run
    # keyframe positions packed for the candidate gate (grown by doubling)
    # and the (i, j) pairs that already have a factor
    _positions: Optional[np.ndarray] = None
    _factor_pairs: set = field(default_factory=set)
    # (K,4,4) world-frame pose deltas of the last optimize(),
    # T_new_k @ inv(T_old_k): the map's reanchor moves keyframe k's points
    # by row k
    last_corrections: Optional[np.ndarray] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # -- event ingestion ----------------------------------------------------
    def add_keyframe(self, stamp: float, pose: np.ndarray, cloud: Optional[PointCloud] = None) -> int:
        pose = np.asarray(pose, np.float64)
        k = len(self.keyframes)
        self.keyframes.append(Keyframe(k, float(stamp), pose, cloud))
        if self._positions is None or k >= self._positions.shape[0]:
            grown = np.zeros((max(256, 0 if self._positions is None else 2 * self._positions.shape[0]), 3), np.float32)
            if self._positions is not None:
                grown[: self._positions.shape[0]] = self._positions
            self._positions = grown
        self._positions[k] = pose[:3, 3]
        if k > 0:
            self.factors.append((k - 1, k, np.linalg.inv(self.keyframes[k - 1].pose) @ pose, 1.0))
            self._factor_pairs.add((k - 1, k))
        return k

    def prewarm(self, example_cloud: PointCloud, iterations: int = 10) -> None:
        """Run the closure-verification GICP on `example_cloud` (a cloud of
        the keyframe clouds' capacity) and one `iterations`-step optimize of
        an all-masked first-bucket graph before serving starts: the kernels
        and their buffers are built then, not on the first closure.
        Records no keyframe or factor."""
        res = gicp_register(example_cloud, example_cloud, guess=torch.eye(4, device=self.device), cfg=self.registration)
        res.transform.cpu()
        eye4 = np.eye(4, dtype=np.float32)
        g = pg.make_graph(
            np.tile(eye4, (POSE_BUCKET, 1, 1)),
            np.zeros(FACTOR_BUCKET, np.int64), np.zeros(FACTOR_BUCKET, np.int64),
            np.tile(eye4, (FACTOR_BUCKET, 1, 1)),
            factor_mask=np.zeros(FACTOR_BUCKET, bool), device=self.device,
        )
        pg.optimize(g, iterations=iterations).poses.cpu()

    # -- loop closure -------------------------------------------------------
    def find_loop_candidates(self) -> List[tuple]:
        """(i, j) pairs near in space and far in sequence, j the newest
        keyframe: one vectorised distance pass over the packed positions."""
        K = len(self.keyframes)
        if K < self.min_index_gap + 1:
            return []
        cur = self.keyframes[-1]
        past = self._positions[: K - self.min_index_gap]
        d2 = np.sum((past - cur.pose[:3, 3].astype(np.float32)) ** 2, axis=1)
        return [(int(i), cur.index) for i in np.nonzero(d2 < self.loop_distance * self.loop_distance)[0]]

    def verify_loop(self, i: int, j: int) -> Optional[np.ndarray]:
        """GICP-align keyframe j's cloud to keyframe i's; accept on
        convergence and fitness. Returns T_ij (float64) or None."""
        a, b = self.keyframes[i], self.keyframes[j]
        if a.cloud is None or b.cloud is None:
            return None
        guess = torch.as_tensor((np.linalg.inv(a.pose) @ b.pose).astype(np.float32)).to(self.device)
        res = gicp_register(b.cloud, a.cloud, guess=guess, cfg=self.registration)
        if not bool(res.converged) or float(res.fitness) > self.loop_fitness_max:
            return None
        return res.transform.cpu().numpy().astype(np.float64)

    def try_close_loops(self) -> int:
        added = 0
        for i, j in self.find_loop_candidates():
            if (i, j) in self._factor_pairs:
                continue
            T = self.verify_loop(i, j)
            if T is not None:
                self.factors.append((i, j, T, 4.0))  # loop factors weighted up
                self._factor_pairs.add((i, j))
                self.loops_found += 1
                added += 1
        return added

    # -- optimization -------------------------------------------------------
    def optimize(self, iterations: int = 10, mesh=None) -> np.ndarray:
        """Optimise every keyframe pose over the bucket-padded graph;
        returns the (K,4,4) corrected poses and updates the keyframes and
        `last_corrections`. `mesh` (factors over a mesh) is ROADMAP A16."""
        if mesh is not None:
            raise NotImplementedError("PoseGraphBackend.optimize(mesh=): factors over a mesh are ROADMAP A16")
        K = len(self.keyframes)
        if K < 2 or not self.factors:
            return np.stack([k.pose for k in self.keyframes]) if K else np.zeros((0, 4, 4))
        old = np.stack([k.pose for k in self.keyframes])
        F = len(self.factors)
        nk, nf = -(-K // POSE_BUCKET) * POSE_BUCKET, -(-F // FACTOR_BUCKET) * FACTOR_BUCKET
        eye4, eye6 = np.eye(4, dtype=np.float32), np.eye(6, dtype=np.float32)
        zero = np.zeros((), np.int64)
        g = pg.make_graph(
            _padded(old.astype(np.float32), nk, eye4),
            _padded(np.asarray([f[0] for f in self.factors], np.int64), nf, zero),
            _padded(np.asarray([f[1] for f in self.factors], np.int64), nf, zero),
            _padded(np.stack([f[2] for f in self.factors]).astype(np.float32), nf, eye4),
            factor_info=_padded(np.stack([eye6 * f[3] for f in self.factors]), nf, eye6),
            factor_mask=_padded(np.ones(F, bool), nf, np.zeros((), bool)),
            device=self.device,
        )
        out = pg.optimize(g, iterations=iterations).poses.cpu().numpy().astype(np.float64)[:K]
        self.solves += 1
        self.last_corrections = np.einsum("kij,kjl->kil", out, np.linalg.inv(old)).astype(np.float32)
        for k, kf in enumerate(self.keyframes):
            kf.pose = out[k]
        self._positions[:K] = out[:, :3, 3].astype(np.float32)
        return out

    def correction_for_latest(self) -> np.ndarray:
        """The pose to push back into the front end
        (`localization.set_integrated_estimate`) after optimize()."""
        return self.keyframes[-1].pose

    def corrections_padded(self, bucket: int = CORRECTIONS_BUCKET) -> np.ndarray:
        """`last_corrections` padded with identities to a multiple of
        `bucket` rows (identity rows leave keyframes beyond K in place)."""
        if self.last_corrections is None:
            raise RuntimeError("optimize() has not run")
        K = self.last_corrections.shape[0]
        return _padded(self.last_corrections, -(-K // bucket) * bucket, np.eye(4, dtype=np.float32))
