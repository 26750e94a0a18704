"""Checkpoint and resume of the full pipeline state (counterpart of
`locus_tpu/checkpoint.py`).

The reference has no state checkpointing: a crashed node is respawned and
loses its map. Here the whole LocusState (pose, buffers, map store,
statistics) round-trips through one `.npz` of its leaves in tree order
(`leaf_0`, `leaf_1`, ...): the order in which the NamedTuples list their
fields, which is also the JAX package's order. The one leaf whose layout
differs is the map's 1-NN operand; `convert.state_from_checkpoint` reads a
checkpoint written by the JAX package.

The sharded pair (`save_state_sharded` / `load_state_sharded`) is ROADMAP
A16.
"""
from __future__ import annotations

import numpy as np
import torch


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


def save_state_sharded(path_prefix: str, state):
    raise NotImplementedError("save_state_sharded: the sharded state is ROADMAP A16")


def load_state_sharded(path_prefix: str, template):
    raise NotImplementedError("load_state_sharded: the sharded state is ROADMAP A16")
