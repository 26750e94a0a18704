"""Kernel B8 (`csrc/eigh.cu`): the float64 6x6 Jacobi eigendecomposition
of the covariance's Ap, in one launch.

Its plain version is `utils/linalg.py::jacobi_eigh` of the symmetrised
Ap, ~1,245 graph nodes on the card (6 sweeps of 5 rounds, each round's
gathers, elementwise ops, index-puts and three cuBLAS double GEMMs). The
kernel runs the same rounds with the same guards and rounds as the plain
version's batched products do, so the two agree bit for bit on a batch
of two or more; on a batch of one (the single step's (6, 6) Ap), whose
cuBLAS products sum in another order, they agree to the last places of
float64. Every member of a batch equals its single call.

`eigh6` takes the path from what it is given: a CPU tensor, or any call
inside `dispatch.no_kernels()`, runs the plain version; a CUDA tensor
launches the kernel, and raises unless it is float64 of shape (..., 6, 6).

Grid: one warp a member, WARPS members a block (`launch_grid`).
"""
from __future__ import annotations

import ctypes

import torch

from locus_tpu_torch.ops import dispatch
from locus_tpu_torch.utils.linalg import jacobi_eigh

N = 6
WARPS = 4   # members a block (csrc/eigh.cu)


def launch_grid(batch: int):
    """((x, y, z) grid, threads a block) of a B8 launch of `batch` members."""
    return ((batch + WARPS - 1) // WARPS, 1, 1), 32 * WARPS


def plain_eigh6(Ap: torch.Tensor):
    """The plain version: `jacobi_eigh` of 0.5 (Ap + Ap^T)."""
    return jacobi_eigh(0.5 * (Ap + Ap.transpose(-1, -2)))


def eigh6(Ap: torch.Tensor):
    """Eigenvalues ascending (..., 6) and eigenvectors as columns
    (..., 6, 6) of the symmetric part of Ap (..., 6, 6), as `plain_eigh6`
    returns them."""
    if not Ap.is_cuda or not dispatch.kernels_enabled():
        return plain_eigh6(Ap)
    from locus_tpu_torch.ops.kernels import build, count_launch

    if Ap.dtype != torch.float64 or Ap.dim() < 2 or tuple(Ap.shape[-2:]) != (N, N):
        raise ValueError(f"locus_eigh6: expected float64 of shape (..., {N}, {N}), got {Ap.dtype} of {tuple(Ap.shape)}")
    lead = Ap.shape[:-2]
    w = torch.empty(lead + (N,), dtype=torch.float64, device=Ap.device)
    v = torch.empty(lead + (N, N), dtype=torch.float64, device=Ap.device)
    Ap = Ap.contiguous()
    fn = build.library("eigh").locus_eigh6
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(Ap.data_ptr(), w.data_ptr(), v.data_ptr(), lead.numel(),
                torch.cuda.current_stream(Ap.device).cuda_stream)
    build.check(status, "locus_eigh6")
    count_launch("eigh6")
    return w, v
