"""The port's PCD reader and writer (`locus_tpu_torch/io/pcd.py`, the
ground-truth-map bootstrap's input) against `locus_tpu.io.pcd`: the same
points give the same file bytes, and either reader reads either writer's
file to the same arrays. Exact checks."""
import jax  # noqa: F401  (imported by every test_torch_* file)
import numpy as np
import pytest

from locus_tpu.io import pcd as jpcd
from locus_tpu_torch.io import pcd as tpcd


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("fields", ["xyz", "xyzi", "xyzinormal"])
def test_pcd_matches_jax(tmp_path, binary, fields):
    rng = np.random.default_rng(7)
    n = 37
    xyz = rng.normal(scale=20.0, size=(n, 3)).astype(np.float32)
    kw = {}
    if "i" in fields:
        kw["intensity"] = rng.uniform(size=n).astype(np.float32)
    if "normal" in fields:
        kw["normals"] = rng.normal(size=(n, 3)).astype(np.float32)
    tpath, jpath = tmp_path / "port.pcd", tmp_path / "jax.pcd"
    tpcd.write_pcd(str(tpath), xyz, binary=binary, **kw)
    jpcd.write_pcd(str(jpath), xyz, binary=binary, **kw)
    assert tpath.read_bytes() == jpath.read_bytes()

    jd = jpcd.read_pcd(str(jpath))
    for path in (tpath, jpath):
        td = tpcd.read_pcd(str(path))
        assert td["_fields"] == jd["_fields"]
        for name in jd["_fields"]:
            np.testing.assert_array_equal(td[name], jd[name])
        txyz, tnrm = tpcd.read_pcd_xyz_normals(str(path))
        jxyz, jnrm = jpcd.read_pcd_xyz_normals(str(path))
        np.testing.assert_array_equal(txyz, jxyz)
        if "normals" in kw:
            np.testing.assert_array_equal(tnrm, jnrm)
        else:
            assert tnrm is None and jnrm is None
    if binary:
        np.testing.assert_array_equal(tpcd.read_pcd_xyz_normals(str(tpath))[0], xyz)
