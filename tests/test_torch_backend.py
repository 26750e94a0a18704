"""The port's pose-graph backend (`locus_tpu_torch/backend.py`) against the
JAX package's: the cases of tests/test_backend.py, both backends fed the
same keyframes. Candidates and factor lists equal; each verified closure
transform within 1e-4 m and 1e-4 in its rotation entries (GICP, as
tests/test_torch_gicp.py holds it); optimised poses within 1e-4 m and
1e-4 (the pose-graph tolerance of tests/test_torch_posegraph.py)."""
import numpy as np
import pytest
import torch

from locus_tpu import backend as jbackend
from locus_tpu.core.cloud import PointCloud as JCloud
from locus_tpu.io import synthetic
from locus_tpu_torch import backend as tbackend
from locus_tpu_torch import localization as tloc
from locus_tpu_torch.core.cloud import PointCloud as TCloud
from tests.test_backend import square_trajectory
from tests.torch_helpers import np_

TOL = 1e-4


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a[..., :3, 3] - b[..., :3, 3]).max() < tol and np.abs(a[..., :3, :3] - b[..., :3, :3]).max() < tol


def _pair(**kw):
    return jbackend.PoseGraphBackend(**kw), tbackend.PoseGraphBackend(device="cpu", **kw)


def test_keyframes_and_sequential_factors():
    jb, tb = _pair()
    gt = square_trajectory()
    for i, p in enumerate(gt[:5]):
        jb.add_keyframe(i * 0.1, p)
        tb.add_keyframe(i * 0.1, p)
    assert len(tb.keyframes) == 5 and len(tb.factors) == 4
    for (i, j, T, w), (ji, jj, jT, jw) in zip(tb.factors, jb.factors):
        assert (i, j, w) == (ji, jj, jw)
        np.testing.assert_array_equal(T, jT)
    np.testing.assert_allclose(tb.factors[0][2], np.linalg.inv(gt[0]) @ gt[1], atol=1e-9)


def test_loop_candidates_spatial_temporal_gates():
    jb, tb = _pair(loop_distance=1.0, min_index_gap=10)
    for i, p in enumerate(square_trajectory()):
        jb.add_keyframe(i * 0.1, p)
        tb.add_keyframe(i * 0.1, p)
    cands = tb.find_loop_candidates()
    assert cands == jb.find_loop_candidates()
    assert any(i == 0 for i, _ in cands) and all(j - i >= 10 for i, j in cands)


def _cube_scans(gt):
    xyz, nrm = synthetic.hollow_cube(step=0.1, side=2.0, jitter=0.02, seed=7)

    def scan_at(pose):
        pts = ((xyz - pose[:3, 3]) @ pose[:3, :3]).astype(np.float32)
        nr = (nrm @ pose[:3, :3]).astype(np.float32)
        return (JCloud.from_points(pts, capacity=1024, normals=nr),
                TCloud.from_points(pts, capacity=1024, normals=nr, device="cpu"))

    return [scan_at(p) for p in gt]


def test_loop_verification_and_optimization():
    """A drifted square loop: the closure verified by GICP on the cube
    pulls the trajectory back toward ground truth, in both packages
    alike."""
    gt = square_trajectory()
    n = gt.shape[0]
    drift = np.linspace(0, 0.25, n)
    est = gt.copy()
    est[:, 0, 3] += drift
    est[:, 1, 3] += drift * 0.5
    jb, tb = _pair(loop_distance=1.5, min_index_gap=10)
    for i, (jc, tc) in enumerate(_cube_scans(gt)):
        jb.add_keyframe(i * 0.1, est[i], cloud=jc)
        tb.add_keyframe(i * 0.1, est[i], cloud=tc)
    added = tb.try_close_loops()
    assert added == jb.try_close_loops() >= 1
    for (i, j, T, w), (ji, jj, jT, jw) in zip(tb.factors, jb.factors):
        assert (i, j, w) == (ji, jj, jw)
        _close(T, jT)
    _close(tb.optimize(iterations=10), jb.optimize(iterations=10))
    _close(tb.last_corrections, jb.last_corrections)
    assert tb.solves == 1
    err_before = np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3])
    err_after = np.linalg.norm(tb.keyframes[-1].pose[:3, 3] - gt[-1, :3, 3])
    assert err_after < err_before * 0.5, (err_before, err_after)


def test_correction_feeds_front_end():
    jb, tb = _pair()
    for i, p in enumerate(square_trajectory()[:12]):
        jb.add_keyframe(i * 0.1, p)
        tb.add_keyframe(i * 0.1, p)
    _close(tb.optimize(iterations=2), jb.optimize(iterations=2))
    corrected = tb.correction_for_latest()
    st = tloc.set_integrated_estimate(tloc.init_state(device="cpu"), corrected)
    np.testing.assert_allclose(np_(st.integrated), corrected, atol=1e-6)


def test_corrections_padded_stable_shape():
    tb = tbackend.PoseGraphBackend(device="cpu")
    shapes = set()
    for i, p in enumerate(square_trajectory()[:12]):
        tb.add_keyframe(i * 0.1, p)
        if i >= 2:
            tb.optimize(iterations=1)
            shapes.add(tb.corrections_padded().shape)
            np.testing.assert_array_equal(tb.corrections_padded()[: i + 1], tb.last_corrections)
    assert shapes == {(tbackend.CORRECTIONS_BUCKET, 4, 4)}
    assert tb.corrections_padded(bucket=8).shape == (16, 4, 4)


def test_prewarm_records_nothing():
    tb = tbackend.PoseGraphBackend(device="cpu")
    _, cloud = _cube_scans(square_trajectory()[:1])[0]
    tb.prewarm(cloud, iterations=3)
    assert tb.keyframes == [] and tb.factors == [] and tb.loops_found == 0 and tb.last_corrections is None


def test_unported_options_raise():
    tb = tbackend.PoseGraphBackend(device="cpu")
    for i, p in enumerate(square_trajectory()[:3]):
        tb.add_keyframe(i * 0.1, p)
    with pytest.raises(NotImplementedError, match="A16"):
        tb.optimize(mesh=object())
    with pytest.raises(RuntimeError, match="optimize"):
        tbackend.PoseGraphBackend(device="cpu").corrections_padded()


def test_backend_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbackend.PoseGraphBackend()
