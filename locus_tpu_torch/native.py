"""ctypes bindings of the native host runtime, `csrc/locus_native.cpp`
(counterpart of `locus_tpu/native/__init__.py`): PCD parsing, fixed-shape
scan packing, a host voxel grid and a threaded scan prefetcher.

The library is built with g++ at first use into `build/native/` beside the
package (keyed by a hash of the source and flags, so an edited source is
rebuilt) and loaded with ctypes. Where the JAX package's loader returns
None and its callers fall back to Python, this one raises: a caller that
asked for the native path (`LiveSession(host_prevoxelize=True)`) never
quietly runs another.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "locus_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _so_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"liblocus_native-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native: could not run g++ on {SRC}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native: g++ failed on {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)


def _declare(L: ctypes.CDLL) -> None:
    f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    L.pcd_open.restype = ctypes.c_void_p
    L.pcd_open.argtypes = [ctypes.c_char_p]
    L.pcd_size.restype = ctypes.c_int64
    L.pcd_size.argtypes = [ctypes.c_void_p]
    L.pcd_has_normals.restype = ctypes.c_int
    L.pcd_has_normals.argtypes = [ctypes.c_void_p]
    L.pcd_has_intensity.restype = ctypes.c_int
    L.pcd_has_intensity.argtypes = [ctypes.c_void_p]
    L.pcd_read.restype = None
    L.pcd_read.argtypes = [ctypes.c_void_p, f32p, f32p, f32p]
    L.pcd_close.restype = None
    L.pcd_close.argtypes = [ctypes.c_void_p]
    L.pack_scan.restype = None
    L.pack_scan.argtypes = [f32p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, f32p, u8p]
    L.voxel_downsample_host.restype = ctypes.c_int64
    L.voxel_downsample_host.argtypes = [f32p, ctypes.c_int64, ctypes.c_float, f32p, ctypes.c_int64]
    L.prefetcher_create.restype = ctypes.c_void_p
    L.prefetcher_create.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_float]
    L.prefetcher_add_files.restype = None
    L.prefetcher_add_files.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64]
    L.prefetcher_start.restype = None
    L.prefetcher_start.argtypes = [ctypes.c_void_p]
    L.prefetcher_next.restype = ctypes.c_int
    L.prefetcher_next.argtypes = [ctypes.c_void_p, f32p, u8p]
    L.prefetcher_destroy.restype = None
    L.prefetcher_destroy.argtypes = [ctypes.c_void_p]


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises RuntimeError when
    it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            so = _so_path()
            if not so.exists():
                _build(so)
            try:
                L = ctypes.CDLL(str(so))
            except OSError as e:
                raise RuntimeError(f"native: cannot load {so}: {e}") from e
            _declare(L)
            _lib = L
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def read_pcd(path: str):
    """(xyz (N,3) f32, normals (N,3) f32 or None, intensity (N,) f32 or
    None) of a PCD file, ASCII or binary."""
    L = lib()
    h = L.pcd_open(str(path).encode())
    if not h:
        raise OSError(f"failed to parse PCD {path}")
    try:
        n = L.pcd_size(h)
        xyz = np.empty((n, 3), np.float32)
        nrm = np.empty((n, 3), np.float32) if L.pcd_has_normals(h) else None
        inten = np.empty((n,), np.float32) if L.pcd_has_intensity(h) else None
        L.pcd_read(h, _fptr(xyz), None if nrm is None else _fptr(nrm), None if inten is None else _fptr(inten))
        return xyz, nrm, inten
    finally:
        L.pcd_close(h)


def pack_scan(xyz: np.ndarray, valid, capacity: int, pad_coord: float = 1e8):
    """Fixed-shape packing of a raw scan, as `runner.pack_scan`: the valid
    points first (up to `capacity`), the rest `pad_coord`; returns (xyz
    (capacity,3) f32, mask (capacity,) bool)."""
    L = lib()
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    v = None if valid is None else np.ascontiguousarray(valid, np.uint8)
    if v is not None and v.shape != (n,):
        raise ValueError(f"pack_scan: valid has shape {v.shape}, expected ({n},)")
    out = np.empty((capacity, 3), np.float32)
    mask = np.empty((capacity,), np.uint8)
    L.pack_scan(_fptr(xyz), None if v is None else _u8ptr(v), n, capacity, pad_coord, _fptr(out), _u8ptr(mask))
    return out, mask.astype(bool)


def voxel_downsample(xyz: np.ndarray, leaf: float, capacity: int | None = None) -> np.ndarray:
    """Host voxel grid: the centroid of the points of each `leaf` voxel,
    at most `capacity` of them, (M,3) f32 (in the library's cell order)."""
    if not leaf > 0:
        raise ValueError(f"voxel_downsample: leaf must be positive, got {leaf}")
    L = lib()
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    cap = xyz.shape[0] if capacity is None else capacity
    out = np.empty((cap, 3), np.float32)
    m = L.voxel_downsample_host(_fptr(xyz), xyz.shape[0], leaf, _fptr(out), cap)
    return out[:m]


class ScanPrefetcher:
    """Threaded PCD prefetch queue: a native worker thread reads and packs
    the files in order (the reference's AsyncSpinner analog for replay).
    Iterate for (xyz (capacity,3), mask (capacity,)); close() ends it."""

    def __init__(self, files, capacity: int, max_queue: int = 8, pad_coord: float = 1e8):
        self._L = lib()
        self.capacity = capacity
        self._h = self._L.prefetcher_create(capacity, max_queue, pad_coord)
        names = (ctypes.c_char_p * len(files))(*[str(f).encode() for f in files])
        self._L.prefetcher_add_files(self._h, names, len(files))
        self._L.prefetcher_start(self._h)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._h:
            raise StopIteration
        xyz = np.empty((self.capacity, 3), np.float32)
        mask = np.empty((self.capacity,), np.uint8)
        if not self._L.prefetcher_next(self._h, _fptr(xyz), _u8ptr(mask)):
            raise StopIteration
        return xyz, mask.astype(bool)

    def close(self) -> None:
        if self._h:
            self._L.prefetcher_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
