"""The port's native host runtime (`locus_tpu_torch/native.py`, the ctypes
loader of csrc/locus_native.cpp): the cases of tests/test_native.py, held
against the port's own Python paths (`io.pcd`, `runner.pack_scan`) and the
JAX package's loader of the same library. Exact: the same bytes parse to
the same floats, packing copies, and both loaders run one C++ voxel grid.
Unlike the JAX package's loader, this one raises when the library cannot
be built."""
import os
import subprocess
import tempfile
import time

import numpy as np
import pytest

from locus_tpu import native as jnative
from locus_tpu_torch import native
from locus_tpu_torch.io import pcd
from locus_tpu_torch.runner import pack_scan
from tests import torch_helpers  # noqa: F401  (caps torch's threads)


def test_pcd_parse_matches_python(tmp_path, rng):
    xyz = rng.normal(size=(100, 3)).astype(np.float32)
    nrm = rng.normal(size=(100, 3)).astype(np.float32)
    inten = rng.uniform(size=100).astype(np.float32)
    p = str(tmp_path / "t.pcd")
    pcd.write_pcd(p, xyz, normals=nrm, intensity=inten, binary=True)
    x2, n2, i2 = native.read_pcd(p)
    d = pcd.read_pcd(p)
    np.testing.assert_array_equal(x2, np.stack([d["x"], d["y"], d["z"]], 1))
    np.testing.assert_array_equal(n2, np.stack([d["normal_x"], d["normal_y"], d["normal_z"]], 1))
    np.testing.assert_array_equal(i2, d["intensity"])
    np.testing.assert_array_equal(x2, xyz)


def test_pcd_parse_ascii(tmp_path, rng):
    xyz = rng.normal(size=(30, 3)).astype(np.float32)
    p = str(tmp_path / "a.pcd")
    pcd.write_pcd(p, xyz, binary=False)
    x2, n2, _ = native.read_pcd(p)
    np.testing.assert_array_equal(x2, pcd.read_pcd_xyz_normals(p)[0])
    np.testing.assert_allclose(x2, xyz, atol=1e-5)
    assert n2 is None


def test_pack_scan_native(rng):
    xyz = rng.normal(size=(20, 3)).astype(np.float32)
    valid = np.ones(20, bool)
    valid[::3] = False
    out, mask = native.pack_scan(xyz, valid, capacity=32)
    ref_out, ref_mask = pack_scan(xyz, valid, 32)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(mask, ref_mask)
    over, over_mask = native.pack_scan(xyz, None, capacity=8)     # truncation
    np.testing.assert_array_equal(over, pack_scan(xyz, np.ones(20, bool), 8)[0])
    assert over_mask.all()


def _build_jax_native_whole():
    """Build the JAX package's library (a build product outside version
    control) into a temporary file beside it and rename it into place, when
    it is missing or older than its source, so that this process never
    leaves a half-written library for another test process to load."""
    so, src = jnative._SO, os.path.abspath(jnative._SRC)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, src, "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@pytest.fixture
def jax_native_lib(monkeypatch):
    """The JAX package's native library, loaded. Its loader builds the
    library in place: while another test process's g++ is still writing it
    a load fails, and the loader then returns None for the rest of the
    process and falls back to numpy, whose cell order is not the library's
    (ROADMAP, known issues of the reference). Build it whole first, then
    wait for any other build to end and load again, so that the comparison
    is always with the library."""
    _build_jax_native_whole()
    deadline = time.monotonic() + 60.0
    while (lib := jnative.lib()) is None:
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native library did not load within 60 s")
        time.sleep(0.5)
        monkeypatch.setattr(jnative, "_tried", False)
    return lib


def test_host_voxel_downsample(rng, jax_native_lib):
    pts = np.array([[0.1, 0.1, 0.1], [0.3, 0.3, 0.3], [5.1, 0.1, 0.1]], np.float32)
    out = native.voxel_downsample(pts, leaf=1.0)
    assert out.shape[0] == 2
    assert any(np.allclose(p, [0.2, 0.2, 0.2], atol=1e-5) for p in out)
    # the centroids of a random cloud, as numpy computes them, in the
    # library's order (the JAX package's loader gives the same order)
    cloud = rng.uniform(-5, 5, size=(2000, 3)).astype(np.float32)
    got = native.voxel_downsample(cloud, leaf=0.7)
    np.testing.assert_array_equal(got, jnative.voxel_downsample(cloud, leaf=0.7))
    keys = np.floor(cloud.astype(np.float64) * (1 / 0.7)).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    ref = np.stack([np.bincount(inv, weights=cloud[:, c]) for c in range(3)], 1) / np.bincount(inv)[:, None]
    order = np.lexsort(got.T)
    np.testing.assert_allclose(got[order], ref.astype(np.float32)[np.lexsort(ref.astype(np.float32).T)], atol=1e-5)
    assert native.voxel_downsample(cloud, leaf=0.7, capacity=10).shape == (10, 3)


def test_prefetcher(tmp_path, rng):
    files, truths = [], []
    for i in range(5):
        xyz = rng.normal(size=(50 + i, 3)).astype(np.float32)
        p = str(tmp_path / f"s{i}.pcd")
        pcd.write_pcd(p, xyz, binary=True)
        files.append(p)
        truths.append(xyz)
    with native.ScanPrefetcher(files, capacity=64, max_queue=2) as pf:
        got = list(pf)
    assert len(got) == 5
    for (xyz, mask), truth in zip(got, truths):
        ref_xyz, ref_mask = pack_scan(truth, np.ones(len(truth), bool), 64)
        np.testing.assert_array_equal(mask, ref_mask)
        np.testing.assert_array_equal(xyz[mask], ref_xyz[ref_mask])


def test_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.voxel_downsample(np.zeros((4, 3), np.float32), 0.5)
