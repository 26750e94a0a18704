"""Device resolution and the kernel A/B switch.

Entry points take `device=None` and resolve it here to the CUDA device;
with no card present they raise instead of quietly running on the CPU.

Each kernel wrapper picks its path from the tensor it is given: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the CUDA
kernel or raises. `no_kernels()` (the counterpart of
`locus_tpu/ops/dispatch.py::no_pallas`) makes the wrappers run their plain
versions on the card too; it exists for A/B comparisons and tests, and is
never a fallback.
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
