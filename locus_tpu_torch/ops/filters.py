"""Point-cloud filters (counterpart of `locus_tpu/ops/filters.py`).

Filters are mask transforms: they never move points, they only invalidate
lanes. This slice ports the crop box; the random, statistical-outlier and
radius-outlier filters come with ROADMAP item A11.
"""
from __future__ import annotations

import torch

from locus_tpu_torch.core.cloud import PointCloud


def crop_box(cloud: PointCloud, box_min, box_max, negative: bool = True) -> PointCloud:
    """Remove (negative=True, the body-filter mode) or keep points inside
    the axis-aligned box."""
    lo = torch.as_tensor(box_min, dtype=torch.float32, device=cloud.xyz.device)
    hi = torch.as_tensor(box_max, dtype=torch.float32, device=cloud.xyz.device)
    inside = torch.all((cloud.xyz >= lo) & (cloud.xyz <= hi), dim=-1)
    return cloud.with_mask(~inside if negative else inside)
