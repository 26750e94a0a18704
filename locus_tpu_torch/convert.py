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
`state_from_sharded_checkpoint` does the same for the files of the JAX
package's `save_state_sharded` (`<prefix>.proc<k>.npz`, each holding the
shards its process could address): it puts every leaf of the whole state
back together from its shards' index ranges, and with a port mesh hands
out this rank's shards.

Layouts that differ: the map's cached 1-NN operand is (8, m_pad) in the
JAX package (rows -2x, -2y, -2z, |t|^2, then zeros) and (m_pad, 4) here.
The map may be either structure: a ring `MapState` or a voxel-hash
`HashMapState` (told apart by its `keys` field).
"""
from __future__ import annotations

import dataclasses
import glob
import re

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


def _proc_files(path_prefix: str) -> list[str]:
    """The `<prefix>.proc<k>.npz` files of a sharded JAX checkpoint, by k;
    raises when there are none or when a k is missing below the highest."""
    found = {}
    for path in glob.glob(glob.escape(path_prefix) + ".proc*.npz"):
        m = re.fullmatch(re.escape(path_prefix) + r"\.proc(\d+)\.npz", path)
        if m:
            found[int(m.group(1))] = path
    if not found:
        raise FileNotFoundError(f"no sharded checkpoint files {path_prefix}.proc<k>.npz")
    missing = sorted(set(range(max(found) + 1)) - set(found))
    if missing:
        raise ValueError(f"sharded checkpoint {path_prefix}: the files of processes {missing} are missing")
    return [found[k] for k in sorted(found)]


def _assemble(name: str, shards: list, shape: tuple) -> np.ndarray:
    """One leaf of the whole state, of `shape`, from its (index ranges
    (ndim, 2), data) shards: a range stored twice must hold the same data,
    and every element must be covered (ValueError naming the leaf
    otherwise)."""
    out = np.zeros(shape, shards[0][1].dtype)
    covered = np.zeros(shape, bool)
    for rng, data in shards:
        if len(rng) != len(shape) or any(lo < 0 or hi > n or lo > hi for (lo, hi), n in zip(rng, shape)):
            raise ValueError(f"leaf {name}: the range {rng.tolist()} of a shard is not in the shape {shape}: "
                             "config mismatch")
        sl = tuple(slice(int(lo), int(hi)) for lo, hi in rng)
        if data.shape != out[sl].shape:
            raise ValueError(f"leaf {name}: a shard of shape {data.shape} is stored for the range {rng.tolist()}")
        seen = covered[sl]
        if seen.any() and not np.array_equal(out[sl][seen], data[seen]):
            raise ValueError(f"leaf {name}: two shards of the range {rng.tolist()} hold different data")
        out[sl] = data
        covered[sl] = True
    if not covered.all():
        raise ValueError(f"leaf {name}: {int((~covered).sum())} of its {covered.size} elements are in no shard "
                         "of the checkpoint's files")
    return out


def state_from_sharded_checkpoint(path_prefix: str, cfg: cfg_mod.LocusConfig, mesh=None, device=None):
    """The port's LocusState from the files the JAX package's
    `checkpoint.save_state_sharded` wrote for the same config (any mesh,
    any number of processes): every leaf assembled from the
    `leaf_{i}_shard_{j}_{data,index}` entries of all the files by their
    index ranges, the map operand turned into the port's rows, each shape
    checked against `pipeline.init_state(cfg)`. With `mesh` (a
    `parallel.mesh.Mesh`), this rank's shards of it (`mesh.shard_state`).
    A state written by a batched replay is not read here."""
    template = pipeline.init_state(cfg, device=device)
    shards: dict[int, list] = {}
    for path in _proc_files(path_prefix):
        with np.load(path) as z:
            for key in z.files:
                m = re.fullmatch(r"leaf_(\d+)_shard_(\d+)_data", key)
                if m:
                    index = z[f"leaf_{m.group(1)}_shard_{m.group(2)}_index"].reshape(-1, 2)
                    shards.setdefault(int(m.group(1)), []).append((index, z[key]))
    restored = []
    for i, (name, tmpl) in enumerate(checkpoint.leaves_with_paths(template)):
        label = f"{i} ({'.'.join(map(str, name))})"
        if i not in shards:
            raise ValueError(f"sharded checkpoint {path_prefix} has no shard of leaf {label}")
        if name[-2:] == ("map", "nn_aug"):
            # the JAX operand is (AUG, m_pad): its rows as stored, m_pad columns
            rows = max(int(rng[0, 1]) for rng, _ in shards[i])
            arr = _operand_rows(_assemble(label, shards[i], (rows, tmpl.shape[-2])))
        else:
            arr = _assemble(label, shards[i], tuple(tmpl.shape))
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {label} shape {tuple(arr.shape)} != template {tuple(tmpl.shape)}: "
                             "config mismatch")
        restored.append(torch.from_numpy(np.array(arr, copy=True)).to(device=tmpl.device, dtype=tmpl.dtype))
    extra = sorted(set(shards) - set(range(len(restored))))
    if extra:
        raise ValueError(f"sharded checkpoint {path_prefix} holds leaves {extra} beyond the config's state")
    state = checkpoint.rebuild(template, iter(restored))
    if mesh is None:
        return state
    from locus_tpu_torch.parallel.mesh import shard_state

    return shard_state(mesh, state, cfg.mapper.map_capacity)
