"""The port's pose-graph solver (`locus_tpu_torch/parallel/posegraph.py`)
against the JAX package's unsharded one on the same factors: positions
within 1e-4 m and rotation entries within 1e-4 (about the angle in rad)
after the same Gauss-Newton and PCG iteration counts (both sum in f32, in
different orders), costs within 1e-4 relative plus 1e-8 absolute. The
padding the backend adds (unconnected identity poses, masked identity
factors) must not move a pose by more than 1e-6."""
import numpy as np
import pytest
import torch

from locus_tpu.parallel import posegraph as jpg
from locus_tpu_torch.parallel import posegraph as tpg
from tests.test_parallel import chain_graph
from tests.torch_helpers import np_

TOL_M = TOL_RAD = 1e-4


def _graphs(est, fi, fj, fT, **kw):
    j = jpg.make_graph(est.astype(np.float32), fi.astype(np.int32), fj.astype(np.int32), fT.astype(np.float32), **kw)
    t = tpg.make_graph(est, fi, fj, fT, device="cpu", **kw)
    return j, t


def _assert_poses_close(tposes, jposes, tol_m=TOL_M, tol_rad=TOL_RAD):
    a, b = np_(tposes).astype(np.float64), np_(jposes).astype(np.float64)
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max()
    dr = np.abs(a[:, :3, :3] - b[:, :3, :3]).max()
    assert dt < tol_m and dr < tol_rad, (dt, dr)


def test_make_graph_defaults():
    gt, est, fi, fj, fT = chain_graph(n=6)
    g = tpg.make_graph(est, fi, fj, fT, device="cpu")
    assert g.poses.dtype == torch.float32 and g.factor_i.dtype == torch.int64
    assert bool(g.factor_mask.all()) and g.anchor == 0
    torch.testing.assert_close(g.factor_info, torch.eye(6).expand(fi.shape[0], 6, 6))


@pytest.mark.parametrize("n,drift,closure", [(12, 0.04, True), (16, 0.03, True), (10, 0.05, False)])
def test_optimize_matches_jax(n, drift, closure):
    gt, est, fi, fj, fT = chain_graph(n=n, drift=drift, loop_closure=closure)
    jg, tg = _graphs(est, fi, fj, fT)
    np.testing.assert_allclose(float(tpg.graph_cost(tg)), float(jpg.graph_cost(jg)), rtol=1e-4, atol=1e-8)
    jg2 = jpg.optimize(jg, iterations=10, cg_iterations=30)
    tg2 = tpg.optimize(tg, iterations=10, cg_iterations=30)
    _assert_poses_close(tg2.poses, jg2.poses)
    np.testing.assert_allclose(float(tpg.graph_cost(tg2)), float(jpg.graph_cost(jg2)), rtol=1e-4, atol=1e-8)


def test_posegraph_reduces_error():
    """tests/test_parallel.py::test_posegraph_reduces_error on the port."""
    gt, est, fi, fj, fT = chain_graph(n=12, drift=0.04)
    g = tpg.make_graph(est, fi, fj, fT, device="cpu")
    c0 = float(tpg.graph_cost(g))
    g2 = tpg.optimize(g, iterations=10, cg_iterations=30)
    assert float(tpg.graph_cost(g2)) < c0 * 0.05
    assert np.linalg.norm(np_(g2.poses)[:, :3, 3] - gt[:, :3, 3], axis=1).max() < 0.15
    np.testing.assert_array_equal(np_(g2.poses)[0], np_(g.poses)[0])   # the anchor stays


def test_padding_leaves_the_solution():
    gt, est, fi, fj, fT = chain_graph(n=12, drift=0.04)
    n, f = est.shape[0], fi.shape[0]
    eye4 = np.eye(4, dtype=np.float32)
    padded = tpg.make_graph(
        np.concatenate([est, np.tile(eye4, (20, 1, 1))]),
        np.concatenate([fi, np.zeros(9, np.int64)]), np.concatenate([fj, np.zeros(9, np.int64)]),
        np.concatenate([fT, np.tile(eye4, (9, 1, 1))]),
        factor_mask=np.concatenate([np.ones(f, bool), np.zeros(9, bool)]), device="cpu",
    )
    bare = tpg.optimize(tpg.make_graph(est, fi, fj, fT, device="cpu"))
    got = tpg.optimize(padded)
    _assert_poses_close(got.poses[:n], bare.poses, 1e-6, 1e-6)
    np.testing.assert_array_equal(np_(got.poses)[n:], np.tile(eye4, (20, 1, 1)))


def test_weighted_factors_match_jax():
    gt, est, fi, fj, fT = chain_graph(n=12, drift=0.04)
    info = np.stack([np.eye(6, dtype=np.float32) * (4.0 if i == len(fi) - 1 else 1.0) for i in range(len(fi))])
    jg, tg = _graphs(est, fi, fj, fT, factor_info=info)
    _assert_poses_close(tpg.optimize(tg).poses, jpg.optimize(jg).poses)


def test_sharded_optimize_raises():
    """optimize_sharded takes a parallel.mesh.Mesh (TypeError otherwise)
    and factors that split evenly over its ranks (ValueError otherwise:
    4 factors over 3)."""
    from locus_tpu_torch.parallel import mesh as tmesh

    gt, est, fi, fj, fT = chain_graph(n=4)
    g = tpg.make_graph(est, fi, fj, fT, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tpg.optimize_sharded(None, g)
    with pytest.raises(ValueError, match="factors"):
        tpg.optimize_sharded(tmesh.Mesh(1, 3, 0, torch.device("cpu"), "gloo"), g)
