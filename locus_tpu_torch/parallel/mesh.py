"""The ("data", "map") process mesh of the sharded deployments
(counterpart of `locus_tpu/parallel/mesh.py`).

- **data**: independent sequences or robots of a batched replay, split
  over the data rows of the mesh (a fleet, or a sweep of dataset replays).
- **map**: the map point store of each robot split along its point axis
  over the map columns (a map larger than one card stays resident).

Rank r holds data row r // M and map column r % M of a (D, M) mesh. The
collectives run on the subgroups of a `torch.distributed` DeviceMesh with
those dims. A mesh of one rank needs no process group.

The JAX package describes a sharded state with PartitionSpecs and lets
`device_put` place the shards; here `state_shard_specs` names the split
axis of every leaf, `shard_state` slices this rank's shards out of a
whole state, and `gather_state` puts a whole state back together.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from locus_tpu_torch.ops.kernels.nn import BT
from locus_tpu_torch.parallel.distributed import gather_ranked

AXES = ("data", "map")


class Mesh:
    """A (data, map) layout of the ranks of the process group, on
    `device`, with collectives through `backend` ("nccl" or "gloo")."""

    def __init__(self, data: int, map_: int, rank: int, device: torch.device, backend: str, device_mesh=None):
        self.shape = {"data": data, "map": map_}
        self.rank = rank
        self.device = device
        self.backend = backend
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["map"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["map"]

    @property
    def map_index(self) -> int:
        return self.rank % self.shape["map"]

    def index(self, axis: str) -> int:
        return self.data_index if axis == "data" else self.map_index

    def group(self, axis: str):
        """The process group of this rank's row along `axis` (None when the
        axis has one rank)."""
        if self.shape[axis] == 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)


def make_mesh(
    n_devices: Optional[int] = None,
    map_parallel: Optional[int] = None,
    device_type: str = "cuda",
    backend: Optional[str] = None,
) -> Mesh:
    """A ("data", "map") mesh over n ranks (default: the process group's
    world size, 1 without a group). `map_parallel` defaults to 2 when n is
    even and > 1, else 1 (as in the JAX package). `backend` defaults to
    "nccl" on the card and "gloo" on the CPU; NCCL takes one rank a device,
    so asking it for more ranks than there are visible devices raises
    (several ranks on one card run on "gloo"). With n > 1 the process group
    must be up (`init_distributed`) with the same world size and backend."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if map_parallel is None:
        map_parallel = 2 if (n % 2 == 0 and n > 1) else 1
    if n < 1 or n % map_parallel:
        raise ValueError(f"{n} ranks do not split into map columns of {map_parallel}")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if device_type != "cuda" or n > visible:
            raise ValueError(
                f"NCCL takes one rank a CUDA device: {n} ranks on {device_type} with {visible} visible devices; "
                "run several ranks on one device with backend='gloo'"
            )
    if device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    if n == 1:
        return Mesh(1, 1, 0, device, backend)
    if world != n:
        raise RuntimeError(f"a mesh of {n} ranks needs a process group of {n} (init_distributed); it has {world}")
    have = dist.get_backend()
    if backend not in have:
        raise ValueError(f"the process group runs {have!r}, the mesh asks for {backend!r}")
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, (n // map_parallel, map_parallel), mesh_dim_names=AXES)
    return Mesh(n // map_parallel, map_parallel, dist.get_rank(), device, backend, device_mesh)


def check_layout(map_capacity: int, n_shards: int) -> None:
    """Raise ValueError unless every map shard tiles into whole BT-point
    target chunks: the per-shard kernels and the incremental cache updates
    must agree on the chunk boundaries of the whole map."""
    if map_capacity % (n_shards * BT) != 0:
        raise ValueError(
            f"map_capacity {map_capacity} must be a multiple of n_shards*BT = {n_shards}*{BT} for the sharded deployment"
        )


def require_mesh(mesh) -> Mesh:
    """`mesh`, or TypeError unless it is a `Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a parallel.mesh.Mesh (make_mesh), not {type(mesh).__name__}")
    return mesh


def check_mesh(mesh, map_capacity: int) -> None:
    """Raise TypeError unless `mesh` is a `Mesh`, ValueError unless the map
    tiles over its map columns (`check_layout`)."""
    check_layout(map_capacity, require_mesh(mesh).shape["map"])


def _fields(tree):
    return getattr(tree, "_fields", None) or range(len(tree))


def _specs(tree, map_capacity: int, lead: tuple, in_map: bool, name=None):
    if isinstance(tree, tuple):
        parts = [
            _specs(sub, map_capacity, lead, in_map or f == "map", f)
            for f, sub in zip(_fields(tree), tree)
        ]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    x, k = tree, len(lead)
    if not isinstance(x, torch.Tensor):
        return lead
    if in_map and name in ("chunk_min", "chunk_max") and x.dim() == 2 + k and x.shape[k] == map_capacity // BT:
        return lead + ("map",)
    if in_map and x.dim() >= 1 + k and x.shape[k] == map_capacity:
        return lead + ("map",)      # the point axis; the 1-NN operand (m_pad, 4) by rows
    return lead


def state_shard_specs(state, map_capacity: int, n_shards: int, batched: bool = False, at_map_root: bool = False):
    """The split of every leaf of a whole LocusState (counterpart of the
    JAX `state_pspecs`): a tuple naming the mesh axis of each leading dim
    that is split ("data" for the batch when `batched`, then "map" for a
    map point axis); a shorter tuple leaves the rest whole.

    A leaf splits over "map" when it lies under the state's `map` node
    (or the tree is a map state: `at_map_root`) AND its point dim has the
    map capacity; the chunk boxes (C, 3) split by chunk rows. The position
    and the shape are both required, so a future leaf of another node with
    a cache's name or the capacity's size stays whole. Requires
    map_capacity % (n_shards * BT) == 0 (`check_layout`)."""
    check_layout(map_capacity, n_shards)
    return _specs(state, map_capacity, ("data",) if batched else (), at_map_root)


def leaf_specs(tree, specs):
    """(leaf, spec) of every leaf of `tree`, in tree order."""
    if isinstance(tree, tuple):
        for t, sp in zip(tree, specs):
            yield from leaf_specs(t, sp)
    else:
        yield tree, specs


def _map_leaves(fn, tree, specs):
    if isinstance(tree, tuple):
        parts = [_map_leaves(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return fn(tree, specs)


def shard_state(mesh: Mesh, state, map_capacity: int, batched: bool = False, at_map_root: bool = False):
    """This rank's shards of a whole state (every rank builds the same
    whole state from the same inputs and keeps its own rows): each split
    dim cut into equal parts along its mesh axis, everything else kept on
    every rank. Replaces the JAX package's `single_state_shardings` /
    `batched_state_shardings` + `device_put`. A batched state is split
    over "data" too; callers that build only their own robots
    (`local_batch_slice`) shard with batched=False semantics per robot or
    pass a state whose batch is already local and `batched=False`."""
    specs = state_shard_specs(state, map_capacity, mesh.shape["map"], batched, at_map_root)

    def cut(x, spec):
        for dim, axis in enumerate(spec):
            n = mesh.shape[axis]
            if n > 1:
                size = x.shape[dim] // n
                x = x.narrow(dim, mesh.index(axis) * size, size)
        return x.clone()

    return _map_leaves(cut, state, specs)


def shard_local_specs(state, mesh: Mesh, map_capacity: int, batched: bool = False, at_map_root: bool = False):
    """The specs of a state already cut to this rank's shards (its map
    leaves hold map_capacity / M points)."""
    check_layout(map_capacity, mesh.shape["map"])
    return _specs(state, map_capacity // mesh.shape["map"], ("data",) if batched else (), at_map_root)


def gather_state(mesh: Mesh, state, map_capacity: int, batched: bool = False, at_map_root: bool = False):
    """The whole state back from every rank's shards (a collective: every
    rank of the mesh must call it), on every rank."""
    specs = shard_local_specs(state, mesh, map_capacity, batched, at_map_root)

    def join(x, spec):
        for dim, axis in reversed(list(enumerate(spec))):
            x = torch.cat(gather_ranked(x, mesh, axis), dim=dim)
        return x

    return _map_leaves(join, state, specs)
