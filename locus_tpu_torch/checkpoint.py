"""Checkpoint and resume of the full pipeline state (counterpart of
`locus_tpu/checkpoint.py`).

The reference has no state checkpointing: a crashed node is respawned and
loses its map. Here the whole LocusState (pose, buffers, map store,
statistics) round-trips through one `.npz` of its leaves in tree order
(`leaf_0`, `leaf_1`, ...): the order in which the NamedTuples list their
fields, which is also the JAX package's order. The one leaf whose layout
differs is the map's 1-NN operand; `convert.state_from_checkpoint` reads a
checkpoint written by the JAX package.

The sharded pair (`save_state_sharded` / `load_state_sharded`) serves the
SPMD deployments of `parallel.mesh`: each rank writes only its own shards
to `<prefix>.proc<rank>.npz`, each leaf beside the whole-state index range
it covers, and a resume reads only its own file and raises unless those
ranges are the ones the resuming mesh gives it. No rank ever needs
another's map shard.
"""
from __future__ import annotations

import numpy as np
import torch

from locus_tpu_torch.parallel.mesh import leaf_specs, require_mesh, shard_local_specs


def leaves_with_paths(tree, path=()):
    """(field path, tensor) of every leaf of a NamedTuple tree, in order."""
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        for name, sub in zip(names, tree):
            yield from leaves_with_paths(sub, path + (name,))
    else:
        yield path, tree


def rebuild(template, leaves):
    """The structure of `template` with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(template, tuple):
        parts = [rebuild(t, leaves) for t in template]
        return type(template)(*parts) if hasattr(template, "_fields") else tuple(parts)
    return next(leaves)


def save_state(path: str, state) -> None:
    """Write every leaf of `state` (fetched to the host) to `path`."""
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy() for i, (_, leaf) in enumerate(leaves_with_paths(state))}
    np.savez_compressed(path, **arrays)


def load_state(path: str, template, convert=None):
    """Restore into the structure, dtypes and device of `template` (build it
    with `pipeline.init_state` of the same config). A leaf whose shape
    differs from the template's raises ValueError (a config mismatch).
    `convert(path_of_leaf, array)`, when given, maps each stored array
    first (a checkpoint of another layout)."""
    with np.load(path) as z:
        restored = []
        for i, (name, tmpl) in enumerate(leaves_with_paths(template)):
            key = f"leaf_{i}"
            if key not in z:
                raise ValueError(f"checkpoint {path} has no {key} ({'.'.join(map(str, name))})")
            arr = z[key] if convert is None else convert(name, z[key])
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"checkpoint leaf {i} ({'.'.join(map(str, name))}) shape {tuple(arr.shape)} != template "
                    f"{tuple(tmpl.shape)}: config mismatch"
                )
            restored.append(torch.from_numpy(np.array(arr, copy=True)).to(device=tmpl.device, dtype=tmpl.dtype))
    return rebuild(template, iter(restored))


def shard_path(path_prefix: str, rank: int) -> str:
    return f"{path_prefix}.proc{rank}.npz"


def _ranges(state, mesh, map_capacity: int, batched: bool):
    """((start, stop) per dim of the whole state) of each of this rank's
    leaves, in tree order."""
    out = []
    for leaf, spec in leaf_specs(state, shard_local_specs(state, mesh, map_capacity, batched)):
        rng = []
        for dim, size in enumerate(leaf.shape):
            axis = spec[dim] if dim < len(spec) else None
            start = mesh.index(axis) * size if axis is not None and mesh.shape[axis] > 1 else 0
            rng.append((start, start + size))
        out.append(np.asarray(rng, np.int64).reshape(-1, 2))
    return out


def save_state_sharded(path_prefix: str, state, mesh, map_capacity: int, batched: bool = False) -> str:
    """This rank's shards of every leaf of `state` (sharded by
    `parallel.mesh.shard_state` over `mesh`, a map of `map_capacity` points
    in the whole state) to `<path_prefix>.proc<rank>.npz`, each with its
    index range in the whole state. Returns the path written."""
    require_mesh(mesh)
    payload = {}
    for i, ((_, leaf), rng) in enumerate(zip(leaves_with_paths(state), _ranges(state, mesh, map_capacity, batched))):
        payload[f"leaf_{i}"] = leaf.detach().cpu().numpy()
        payload[f"leaf_{i}_index"] = rng
    out = shard_path(path_prefix, mesh.rank)
    np.savez_compressed(out, **payload)
    return out


def load_state_sharded(path_prefix: str, template, mesh, map_capacity: int, batched: bool = False):
    """Restore this rank's file into the structure, dtypes and device of
    `template` (this rank's shards of a fresh state of the same config).
    Raises ValueError when a saved leaf covers another index range of the
    whole state than the template's: the resume must use the same mesh
    and process layout as the save."""
    require_mesh(mesh)
    path = shard_path(path_prefix, mesh.rank)
    want = _ranges(template, mesh, map_capacity, batched)
    with np.load(path) as z:
        restored = []
        for i, ((name, tmpl), rng) in enumerate(zip(leaves_with_paths(template), want)):
            if f"leaf_{i}" not in z:
                raise ValueError(f"checkpoint {path} has no leaf_{i} ({'.'.join(map(str, name))})")
            have = z[f"leaf_{i}_index"]
            if not np.array_equal(have, rng):
                raise ValueError(
                    f"checkpoint {path} leaf {i} ({'.'.join(map(str, name))}) covers {have.tolist()} of the whole "
                    f"state, this rank's shard is {rng.tolist()}: resume with the same mesh/process layout as the save"
                )
            arr = z[f"leaf_{i}"]
            restored.append(torch.from_numpy(np.array(arr, copy=True)).to(device=tmpl.device, dtype=tmpl.dtype))
    return rebuild(template, iter(restored))
