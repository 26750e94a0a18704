"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). Builds happen at first use, into `build/kernels/` beside the
package, and are keyed by a hash of the source so an edited kernel is
rebuilt. `build()` compiles several sources in parallel, one nvcc process
each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("nn", "moments", "graph", "gicp", "eigh")  # the sources the pipeline runs (graph: the IF nodes of a captured step)
FLOOR = "floor"              # the empty kernel that measurements time beside them
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# flags of one source besides NVCC_FLAGS: B7 and B8 round every product and
# sum as PyTorch's separate kernels do, so nothing may contract into an FMA
EXTRA_FLAGS = {"gicp": ("-fmad=false",), "eigh": ("-fmad=false",)}

_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource report of each build made in this process
build_logs: dict[str, str] = {}
# nvcc builds started in this process (a server that has warmed up builds
# none while it serves)
builds = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile the named kernels that are not built yet, all at once.
    Returns the seconds each build took (0.0 for one already built)."""
    global builds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds = {name: 0.0 for name in names}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds += 1
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def launch_empty(grid, threads: int, stream: int) -> None:
    """Launch the empty kernel of `csrc/floor.cu` with `grid` (x, y, z) and
    `threads` per block on `stream` (a `cuda_stream` handle)."""
    fn = library(FLOOR).locus_empty
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(*grid, threads, stream), "locus_empty")


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
