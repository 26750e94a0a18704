"""Carry configuration and state over from the JAX package.

`config_from_dict` rebuilds the port's LocusConfig from
`dataclasses.asdict` of the JAX package's LocusConfig
(`locus_tpu/config.py`).
`state_from_numpy` turns a JAX `LocusState` whose leaves were converted to
numpy arrays (its tree mapped through `np.asarray`) into the port's
LocusState on a device, so a replay can run k scans in JAX and continue in
the port. A stacked JAX state (the batched replay's: every leaf with a
leading B) becomes the port's batched state the same way. Neither
function imports JAX: they read plain attributes.

`state_from_checkpoint` reads a checkpoint that the JAX package's
`checkpoint.save_state` wrote (its leaves in the same tree order) into the
port's LocusState, so a session can resume in the port where JAX stopped.

Layouts that differ: the map's cached 1-NN operand is (8, m_pad) in the
JAX package (rows -2x, -2y, -2z, |t|^2, then zeros) and (m_pad, 4) here.
The map may be either structure: a ring `MapState` or a voxel-hash
`HashMapState` (told apart by its `keys` field).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from locus_tpu_torch import checkpoint
from locus_tpu_torch import config as cfg_mod
from locus_tpu_torch import fusion, localization, odometry, pipeline
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.mapping.keyframe_map import MapState
from locus_tpu_torch.mapping.voxel_hash_map import HashMapState


def _build_dataclass(cls, d: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = f.default_factory() if f.default_factory is not dataclasses.MISSING else None
        if dataclasses.is_dataclass(sub) and isinstance(v, dict):
            v = _build_dataclass(type(sub), v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def config_from_dict(d: dict) -> cfg_mod.LocusConfig:
    """The port's LocusConfig from `dataclasses.asdict` of the JAX one."""
    return _build_dataclass(cfg_mod.LocusConfig, d)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tuple(cls, obj, device, **special):
    """Instance of NamedTuple `cls` from the same-named attributes of
    `obj`; `special` maps a field name to a converter of that attribute."""
    vals = []
    for name in cls._fields:
        v = getattr(obj, name)
        vals.append(special[name](v) if name in special else _tensor(v, device))
    return cls(*vals)


def _cloud(obj, device) -> PointCloud:
    return _tuple(PointCloud, obj, device)


def state_from_numpy(tree, device) -> pipeline.LocusState:
    """The port's LocusState from a JAX LocusState with numpy leaves."""
    dev = torch.device(device)
    jmap = tree.map
    nn_aug = _operand_rows(jmap.nn_aug)   # (..., m_pad, 4)
    map_state = _tuple(
        HashMapState if hasattr(jmap, "keys") else MapState, jmap, dev,
        cloud=lambda c: _cloud(c, dev),
        nn_aug=lambda _: _tensor(nn_aug, dev),
    )
    fuse = _tuple(
        fusion.FusionState, tree.fuse, dev,
        imu=lambda b: _tuple(fusion.ImuBuffer, b, dev),
        odom=lambda b: _tuple(fusion.OdomBuffer, b, dev),
    )
    return pipeline.LocusState(
        odom=_tuple(odometry.OdometryState, tree.odom, dev, reference=lambda c: _cloud(c, dev)),
        loc=_tuple(localization.LocalizationState, tree.loc, dev),
        map=map_state,
        fuse=fuse,
        voxel_leaf=_tensor(tree.voxel_leaf, dev),
        last_keyframe_pose=_tensor(tree.last_keyframe_pose, dev),
        previous_stamp=_tensor(tree.previous_stamp, dev),
        velocities=_tuple(pipeline.VelocityBuffer, tree.velocities, dev),
        open_space=_tensor(tree.open_space, dev),
        stats=_tuple(pipeline.Stats, tree.stats, dev),
    )


def _operand_rows(nn_aug: np.ndarray) -> np.ndarray:
    """The JAX (8, m_pad) operand as the port's (m_pad, 4) rows."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(nn_aug)[..., :4, :], -1, -2))


def state_from_checkpoint(path: str, cfg: cfg_mod.LocusConfig, device) -> pipeline.LocusState:
    """The port's LocusState from a checkpoint the JAX package wrote for the
    same config (`save_state`): every leaf in tree order, the map operand
    transposed to the port's layout, each shape checked."""
    template = pipeline.init_state(cfg, device=device)

    def convert(name, arr):
        return _operand_rows(arr) if name[-2:] == ("map", "nn_aug") else arr

    return checkpoint.load_state(path, template, convert=convert)
