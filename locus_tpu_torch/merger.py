"""Multi-lidar merging with health-aware failover (counterpart of
`locus_tpu/merger.py`).

Re-design of point_cloud_merger (PointCloudMerger.cc) + the
sensors_health_monitor watchdog (locus/src/sensors_health_monitor.py):

- the reference ApproximateTime-synchronizes 2-3 lidar topics and
  *rebuilds the subscriber graph* when a sensor dies or resurrects
  (.cc:191-250). Here, scans arrive as fixed-shape per-lidar slots with
  validity masks, so failover is pure masking — a dead lidar contributes
  zero valid points and the merged cloud is unchanged in shape.
- per-lidar watchdog timers (1 s timeout) become timestamp comparisons
  carried in MergerState, in float32 on the state's device as in the JAX
  package.

Where the JAX package takes a PRNG key for the random filter, this one
takes a CPU `torch.Generator` (`ops.filters.random_sample`): the same law,
another draw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from locus_tpu_torch import diagnostics
from locus_tpu_torch.config import MergerConfig
from locus_tpu_torch.core import cloud as cloud_lib
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.ops import filters
from locus_tpu_torch.ops.dispatch import resolve_device


class MergerState(NamedTuple):
    last_reception: torch.Tensor   # (L,) f32 per-lidar last message time
    alive: torch.Tensor            # (L,) bool health flags (diagnostics)


def init_state(num_lidars: int, device=None) -> MergerState:
    """A state on `device` (None: the CUDA device) with no lidar heard."""
    dev = resolve_device(device)
    return MergerState(
        last_reception=torch.full((num_lidars,), -torch.inf, dtype=torch.float32, device=dev),
        alive=torch.zeros((num_lidars,), dtype=torch.bool, device=dev),
    )


def observe(state: MergerState, lidar_index: int, stamp) -> MergerState:
    """Record a message reception (health monitor heartbeat).

    The stamp reaches the state's device as a kernel argument (`fill_`):
    an indexed write of a Python number (`last[i] = stamp`) stages it
    through a CPU tensor and a host-to-device copy that waits for the
    device, so the merger's host work could not overlap the last step."""
    with diagnostics.process_timer.time("merger.observe"):
        last, alive = state.last_reception.clone(), state.alive.clone()
        last[lidar_index].fill_(stamp)
        alive[lidar_index].fill_(True)
        return MergerState(last, alive)


def health(state: MergerState, now, timeout: float = 1.0) -> torch.Tensor:
    """(L,) bool — per-lidar liveness (failure_detection /
    resurrection_detection equivalent: purely a function of reception
    times, so 'resurrection' is automatic)."""
    with diagnostics.process_timer.time("merger.health"):
        if not isinstance(now, torch.Tensor):
            now = float(now)   # a Python float keeps the difference in f32, as in the JAX package
        return (now - state.last_reception) < timeout


def merge(
    clouds: Sequence[PointCloud],
    extrinsics: Sequence,
    alive: torch.Tensor,
    cfg: MergerConfig = MergerConfig(),
    generator: Optional[torch.Generator] = None,
    capacity: Optional[int] = None,
) -> PointCloud:
    """Merge per-lidar clouds (sensor frames) into one base-frame cloud on
    the clouds' device.

    `extrinsics[i]` is the 4x4 lidar_i->base transform (the reference gets
    these via TF from sensor_description URDF). Dead lidars (alive[i]
    False) are masked out — the 3->2->1->0 failover.
    Optional random / radius filters mirror PointCloudMerger.cc:123-178;
    the random filter draws from `generator` (a CPU generator seeded with
    0 when None). Each of `observe`, `health` and `merge` is a span of
    `diagnostics.process_timer`.
    """
    with diagnostics.process_timer.time("merger.merge"):
        if len(clouds) != cfg.number_of_velodynes:
            # the reference builds its sync graph from this count and warns
            # on other values (PointCloudMerger.cc:64-84)
            raise ValueError(
                f"merge got {len(clouds)} clouds but cfg.number_of_velodynes="
                f"{cfg.number_of_velodynes}"
            )
        transformed = []
        for i, (c, T) in enumerate(zip(clouds, extrinsics)):
            # a host transform goes up without waiting for the device (a
            # copy from pageable memory is staged before the call returns)
            c = c.transform(torch.as_tensor(T, dtype=torch.float32).to(c.xyz.device, non_blocking=True))
            # upstream pcl/PassThrough per lidar (locus.launch:90-133:
            # z in ±passthrough_limit around base_link, the frame transform
            # itself is the line above)
            if cfg.b_use_passthrough:
                c = filters.passthrough(c, "z", -cfg.passthrough_limit, cfg.passthrough_limit)
            c = c.with_mask(c.mask & alive[i])
            transformed.append(c)
        merged = cloud_lib.concatenate(transformed, capacity=capacity)

        if cfg.b_use_random_filter:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            merged = filters.random_sample(merged, generator, cfg.decimate_percentage)
        if cfg.b_use_radius_filter:
            merged = filters.radius_outlier(merged, cfg.radius, cfg.radius_knn)
        return merged
