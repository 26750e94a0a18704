"""Mapper structure registry (counterpart of
`locus_tpu/mapping/registry.py`, the reference's `mapperFabric`): the ring
map and the voxel-hash map."""
from __future__ import annotations

from locus_tpu_torch.config import MapperConfig


def mapper_fabric(cfg_or_name):
    """Resolve a mapper module from a MapperConfig or a structure name."""
    name = cfg_or_name.structure if isinstance(cfg_or_name, MapperConfig) else cfg_or_name
    if name == "ring":
        from locus_tpu_torch.mapping import keyframe_map

        return keyframe_map
    if name == "voxel_hash":
        from locus_tpu_torch.mapping import voxel_hash_map

        return voxel_hash_map
    raise ValueError(f"unknown mapper structure {name!r}; expected 'ring' or 'voxel_hash'")
