"""Point-cloud filters (counterpart of `locus_tpu/ops/filters.py`).

Filters are mask transforms: they never move points, they only invalidate
lanes. The crop box (the body filter) and pcl::PassThrough, RandomSample,
StatisticalOutlierRemoval and RadiusOutlierRemoval semantics
(PointCloudFilter.cc:85-176). The JAX package runs them as XLA; they are
plain PyTorch here.
"""
from __future__ import annotations

import torch

from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.ops import neighbors


def crop_box(cloud: PointCloud, box_min, box_max, negative: bool = True) -> PointCloud:
    """Remove (negative=True, the body-filter mode) or keep points inside
    the axis-aligned box."""
    lo = torch.as_tensor(box_min, dtype=torch.float32, device=cloud.xyz.device)
    hi = torch.as_tensor(box_max, dtype=torch.float32, device=cloud.xyz.device)
    inside = torch.all((cloud.xyz >= lo) & (cloud.xyz <= hi), dim=-1)
    return cloud.with_mask(~inside if negative else inside)


def passthrough(
    cloud: PointCloud, field: str = "z", limit_min: float = -100.0, limit_max: float = 100.0,
    negative: bool = False,
) -> PointCloud:
    """Keep points whose `field` coordinate lies in [limit_min, limit_max]
    (negative=True inverts)."""
    v = cloud.xyz[:, {"x": 0, "y": 1, "z": 2}[field]]
    inside = (v >= limit_min) & (v <= limit_max)
    return cloud.with_mask(~inside if negative else inside)


def random_sample(cloud: PointCloud, generator: torch.Generator, decimate_percentage) -> PointCloud:
    """Randomly discard `decimate_percentage` (a float or a 0-d tensor) of
    the lanes. The uniform draw comes from `generator`, a CPU generator,
    and is then moved to the cloud's device, so one seed gives one draw on
    the CPU and the card alike. Torch's generator is not the JAX PRNG: the
    draw is not the JAX package's, only its law is."""
    u = torch.rand((cloud.capacity,), generator=generator, dtype=torch.float32).to(cloud.xyz.device)
    return cloud.with_mask(u >= decimate_percentage)


def statistical_outlier(cloud: PointCloud, knn: int = 10, std_mult: float = 1.0) -> PointCloud:
    """Remove points whose mean distance to their `knn` nearest neighbours
    exceeds the valid points' mean of it plus `std_mult` standard
    deviations."""
    # +1: the point itself is its own 0-distance neighbour
    d2, _ = neighbors.knn(cloud.xyz, cloud.xyz, k=knn + 1)
    mean_d = torch.mean(torch.sqrt(torch.clamp(d2[:, 1:], min=0.0)), dim=1)
    w = cloud.mask.to(torch.float32)
    denom = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(torch.where(cloud.mask, mean_d, 0.0)) / denom
    var = torch.sum(torch.where(cloud.mask, (mean_d - mu) ** 2, 0.0)) / denom
    thresh = mu + std_mult * torch.sqrt(torch.clamp(var, min=0.0))
    return cloud.with_mask(mean_d <= thresh)


def radius_outlier(cloud: PointCloud, radius: float = 0.15, min_neighbors: int = 3) -> PointCloud:
    """Remove points with fewer than `min_neighbors` other points within
    `radius`."""
    counts = neighbors.radius_count(cloud.xyz, cloud.xyz, radius)
    return cloud.with_mask((counts - 1) >= min_neighbors)
