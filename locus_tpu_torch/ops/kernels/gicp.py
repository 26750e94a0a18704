"""Kernel B7 (`csrc/gicp.cu`): one trip of the GICP loop after its 1-NN,
on the disk-covariance path, in one launch.

Its plain version is the trip of `registration/gicp.py` (`gicp_register`),
some 700 elementwise PyTorch kernels on the card: the weights and gathers
of the correspondences, the disk covariances' inverses, each inner
Gauss-Newton step (the 27 column sums, the ridge, the float64 6x6 solve,
`se3_exp`, the composition), the re-orthonormalisation, the convergence
metric, the fitness and the per-member carry writes. The kernel rounds
every step as those kernels do, so the two agree bit for bit.

`gicp_register` takes the kernel where it can see that the kernel applies:
CUDA tensors, kernels enabled (not inside `dispatch.no_kernels()`), and
the "normals" covariance mode without explicit covariances (the disks).
Every other call runs the plain trip; a CUDA call with kernels enabled
that does so (a mode whose covariances are full 3x3 matrices) counts its
trips in the launch row `gicp_plain_trips`, and each B7 launch counts in
`gicp_trip`. The kernel takes 1 to MAX_POINTS source points a member
(32,768; every configured scan capacity is 4,096 or less); above, the
wrapper raises.

Grid: one block of THREADS threads a batch member (the leading dimension
of the batched replay); with more than one member a second launch of one
warp sets the loop's flag from every member's. Dynamic shared memory:
COLUMNS columns of THREADS floats (`launch_grid`). Scratch, per call:
each point's record (four float4, in four planes) and the members' flags.
"""
from __future__ import annotations

import ctypes

import torch

from locus_tpu_torch.ops import graph

THREADS = 1024     # a block: one member (csrc/gicp.cu)
MAX_LEAVES = 32    # points a thread owns
TERMS = 27         # the Gauss-Newton step's column sums
COLUMNS = TERMS + 2  # and the correspondences' two
MAX_POINTS = THREADS * MAX_LEAVES


def launch_grid(batch: int):
    """((x, y, z) grid, threads a block, dynamic shared bytes) of a B7
    launch of `batch` members: one block a member, a word of each of the
    COLUMNS columns a thread."""
    return (batch, 1, 1), THREADS, COLUMNS * THREADS * 4


def _check(x: torch.Tensor, name: str, dtype, shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} of shape {tuple(shape)}, got {x.dtype} of {tuple(x.shape)}")


def gicp_trip(p, nn_idx, source, target, carry, cfg) -> None:
    """Launch B7 for one trip: p (..., N, 3) the source at the carried
    transform (the 1-NN's queries), nn_idx (..., n_pad) int32 the 1-NN
    kernel's winners, `source` (src0 (..., N, 3), its rotated normals,
    mask (..., N) bool) and `target` (xyz (..., M, 3), normals, mask), the
    loop's carry (T (..., 4, 4), it int32, delta, fitness, ncorr int32,
    j_fin (..., N) int64, d2_fin (..., N), go 0-d bool) written in place,
    `cfg` the RegistrationConfig. Raises on anything the kernel does not
    take."""
    from locus_tpu_torch.ops.kernels import build, count_launch

    src, src_n, src_mask = source
    tgt, tgt_n, tgt_mask = target
    T, it, delta, fitness, ncorr, j_fin, d2_fin, go = carry
    lead, n, m = src_mask.shape[:-1], src_mask.shape[-1], tgt_mask.shape[-1]
    f32, i32 = torch.float32, torch.int32
    if not 1 <= n <= MAX_POINTS or m < 1 or nn_idx.shape[-1] < n:
        raise ValueError(f"locus_gicp_trip: {n} source points (1 to {MAX_POINTS}), {m} targets, "
                         f"{nn_idx.shape[-1]} 1-NN rows")
    operands = (
        (p, "p", f32, lead + (n, 3)), (nn_idx, "nn_idx", i32, lead + nn_idx.shape[-1:]),
        (src, "src", f32, lead + (n, 3)), (src_n, "src_normals", f32, lead + (n, 3)),
        (src_mask, "src_mask", torch.bool, lead + (n,)), (tgt, "tgt", f32, lead + (m, 3)),
        (tgt_n, "tgt_normals", f32, lead + (m, 3)), (tgt_mask, "tgt_mask", torch.bool, lead + (m,)),
        (T, "T", f32, lead + (4, 4)), (it, "it", i32, lead), (delta, "delta", f32, lead),
        (fitness, "fitness", f32, lead), (ncorr, "ncorr", i32, lead), (j_fin, "j_fin", torch.int64, lead + (n,)),
        (d2_fin, "d2_fin", f32, lead + (n,)), (go, "go", torch.bool, ()),
    )
    batch = lead.numel()
    for x, name, dtype, shape in operands:
        _check(x, name, dtype, shape)
    dev = p.device
    for x, name, _, _ in operands:
        if x.device != dev or dev.type != "cuda" or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor on the CUDA device of p, "
                             f"got one on {x.device} (contiguous={x.is_contiguous()})")
    enable = graph.predicate()
    alive = torch.empty(batch, dtype=torch.bool, device=dev) if batch > 1 else None
    records = torch.empty((batch, 4, n, 4), dtype=torch.float32, device=dev)
    fn = build.library("gicp").locus_gicp_trip
    ptr, num, real = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr, ptr, num] + [ptr] * 6 + [num] * 3 + [ptr] * 11 + [num] * 2 + [real] * 5 + [ptr])
    fn.restype = ctypes.c_int
    status = fn(
        p.data_ptr(), nn_idx.data_ptr(), nn_idx.shape[-1], src.data_ptr(), src_n.data_ptr(), src_mask.data_ptr(),
        tgt.data_ptr(), tgt_n.data_ptr(), tgt_mask.data_ptr(), batch, n, m, T.data_ptr(), it.data_ptr(),
        delta.data_ptr(), fitness.data_ptr(), ncorr.data_ptr(), j_fin.data_ptr(), d2_fin.data_ptr(),
        None if alive is None else alive.data_ptr(), go.data_ptr(), None if enable is None else enable.data_ptr(),
        records.data_ptr(), cfg.iterations, cfg.inner_iterations, cfg.corr_dist * cfg.corr_dist, 1.0 - cfg.gicp_epsilon,
        cfg.levenberg_lambda, 1.0 / cfg.rotation_epsilon, 1.0 / cfg.tf_epsilon,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "locus_gicp_trip")
    count_launch("gicp_trip")
