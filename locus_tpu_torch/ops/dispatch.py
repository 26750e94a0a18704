"""Device resolution and the kernel A/B switch.

Entry points take `device=None` and resolve it here to the CUDA device;
with no card present they raise instead of quietly running on the CPU.

Each kernel wrapper picks its path from the tensor it is given: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the CUDA
kernel or raises. `no_kernels()` (the counterpart of
`locus_tpu/ops/dispatch.py::no_pallas`) makes the wrappers run their plain
versions on the card too; it exists for A/B comparisons and tests, and is
never a fallback.

The sharded deployments set a shard context (`shard_context`, the
counterpart of the JAX `shard_axis`): inside it the mapping layer sees
this rank's shard of the map and merges across the mesh's "map" axis.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_disable_kernels = contextvars.ContextVar("locus_torch_disable_kernels", default=False)


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; raise when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def kernels_enabled() -> bool:
    """False inside `no_kernels()`."""
    return not _disable_kernels.get()


@contextlib.contextmanager
def no_kernels():
    """Run the enclosed calls through the plain PyTorch versions of the
    kernels, also for CUDA tensors (A/B comparisons)."""
    token = _disable_kernels.set(True)
    try:
        yield
    finally:
        _disable_kernels.reset(token)


# The shard context of the sharded deployments (counterpart of the JAX
# `shard_axis`): when set, this process is one shard of the map point
# axis, the map leaves the mapping layer sees are this shard's rows, and
# cross-shard results come from rank-ordered collectives over the mesh's
# "map" group. Set by the runner's `mesh=` entry points while they step.
_shard = contextvars.ContextVar("locus_torch_shard", default=None)


def active_shard():
    """The enclosing `parallel.mesh.Mesh` when the map is split over more
    than one shard, else None."""
    return _shard.get()


@contextlib.contextmanager
def shard_context(mesh):
    """Run the enclosed calls as shard `mesh.map_index` of `mesh.shape["map"]`
    (a no-op context for an unsplit map, as the JAX package skips the
    collectives on a map axis of 1)."""
    token = _shard.set(mesh if mesh is not None and mesh.shape["map"] > 1 else None)
    try:
        yield
    finally:
        _shard.reset(token)
