"""The port's distribution layer (`locus_tpu_torch/parallel/`) against the
JAX package's tests/test_parallel.py cases. The JAX functions run on the
8-device CPU mesh (`make_mesh(8, map_parallel=4)`); the port's on 4 gloo
ranks on the CPU with the map split 4 ways (tests/torch_ranks.py), so
both split the map over 4 shards.

Tolerances:
- every rank returns the same bits (the merges are rank-ordered);
- sharded k-NN and 1-NN equal the port's unsharded search bit for bit;
  against JAX's sharded search: d2 within rtol 1e-4 / atol 1e-4, indices
  on > 99 % of rows (the JAX test's own bound against the local search),
  1-NN indices equal the brute-force argmin;
- the per-shard B2 merge (its plain version on the CPU): indices equal
  the brute-force argmin and JAX's, d2 within rtol 1e-4 / atol 1e-5;
  queries beyond the radius +inf in both;
- the sharded pose graph: within 5e-3 of the port's `optimize` and of
  JAX's `optimize_sharded` (the JAX test's tolerance);
- a sharded map's inserts and re-anchor, and the sharded checkpoint,
  equal the unsharded map bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from locus_tpu.config import FilterConfig, LocusConfig, MapperConfig
from locus_tpu import pipeline as jpl
from locus_tpu.parallel import mesh as jmesh
from locus_tpu.parallel import posegraph as jpg
from locus_tpu.parallel import sharded_map as jsm
from locus_tpu_torch import checkpoint as tckpt
from locus_tpu_torch import pipeline as tpl
from locus_tpu_torch.config import MapperConfig as TMapperConfig
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.mapping import keyframe_map as tkm
from locus_tpu_torch.ops import neighbors
from locus_tpu_torch.ops.kernels.nn import BT
from locus_tpu_torch.parallel import distributed as tdist
from locus_tpu_torch.parallel import mesh as tmesh
from locus_tpu_torch.parallel import posegraph as tpg
from locus_tpu_torch.parallel import sharded_map as tsm
from tests.test_parallel import chain_graph
from tests.torch_helpers import np_
from tests.torch_ranks import launch_cases, launch_tool

SHARDS = 4


@pytest.fixture(scope="module")
def mesh8():
    return jmesh.make_mesh(8, map_parallel=SHARDS)


def _corrections():
    """tests/test_parallel.py::test_sharded_reanchor_matches_single's
    corrections: keyframe 1 shifted, keyframe 2 rotated and shifted."""
    from locus_tpu.geometry import se3

    corr = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    corr[1] = np.asarray(se3.make_transform(jnp.eye(3), jnp.asarray([0.3, -0.2, 0.1])))
    corr[2] = np.asarray(se3.make_transform(np.asarray(se3.so3_exp(jnp.asarray([0.0, 0.0, 0.1]))),
                                            jnp.asarray([-0.1, 0.4, 0.0])))
    return corr


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1234)
    f32 = np.float32
    _, est, fi, fj, fT = chain_graph(n=16, drift=0.03)
    F = len(fi)
    pad = (-F) % SHARDS
    return {
        "knn_q": (rng.normal(size=(64, 3)) * 5).astype(f32), "knn_m": (rng.normal(size=(1024, 3)) * 5).astype(f32),
        "near_q": rng.normal(size=(32, 3)).astype(f32), "near_m": rng.normal(size=(512, 3)).astype(f32),
        "pallas_m": (rng.normal(size=(SHARDS * BT, 3)) * 4).astype(f32),
        "pallas_q": (rng.normal(size=(256, 3)) * 4).astype(f32),
        "pg_est": est.astype(f32), "pg_fi": np.concatenate([fi, np.zeros(pad, np.int64)]),
        "pg_fj": np.concatenate([fj, np.zeros(pad, np.int64)]),
        "pg_fT": np.concatenate([fT, np.tile(np.eye(4, dtype=f32), (pad, 1, 1))]).astype(f32),
        "pg_mask": np.concatenate([np.ones(F, bool), np.zeros(pad, bool)]),
        "map_capacity": np.asarray(SHARDS * BT),
        "kf_points": np.stack([(rng.normal(size=(256, 3)) * 4 + k).astype(f32) for k in range(3)]),
        "corrections": _corrections(),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    outs = launch_cases(tmp_path_factory.mktemp("parallel"), "unit", SHARDS, inputs)
    for key in outs[0]:
        if key != "ckpt_layout_error":
            for r in range(1, SHARDS):
                np.testing.assert_array_equal(outs[r][key], outs[0][key], err_msg=f"rank {r} {key}")
    return outs


def test_sharded_knn_matches_jax(inputs, ranks, mesh8):
    got_d2, got_idx = ranks[0]["knn_d2"], ranks[0]["knn_idx"]
    d2, idx = neighbors.knn(torch.from_numpy(inputs["knn_q"]), torch.from_numpy(inputs["knn_m"]), k=8)
    np.testing.assert_array_equal(got_d2, np_(d2))
    np.testing.assert_array_equal(got_idx, np_(idx))
    jd2, jidx = jsm.sharded_knn(mesh8, jnp.asarray(inputs["knn_q"]), jnp.asarray(inputs["knn_m"]), k=8)
    np.testing.assert_allclose(got_d2, np.asarray(jd2), rtol=1e-4, atol=1e-4)
    assert np.mean(got_idx == np.asarray(jidx)) > 0.99


def test_sharded_nearest_matches_jax(inputs, ranks, mesh8):
    q, m = inputs["near_q"], inputs["near_m"]
    brute = np.argmin(np.linalg.norm(q[:, None] - m[None], axis=-1) ** 2, axis=1)
    np.testing.assert_array_equal(ranks[0]["nearest_idx"], brute)
    _, jidx = jsm.sharded_nearest(mesh8, jnp.asarray(q), jnp.asarray(m))
    np.testing.assert_array_equal(ranks[0]["nearest_idx"], np.asarray(jidx))


def test_sharded_nearest_pallas_matches_jax(inputs, ranks, mesh8):
    """Per-shard B2 (its plain version on the CPU) and the winners' merge,
    against JAX's per-shard Pallas kernel (interpret mode) and merge; the
    far queries come back +inf in both."""
    from locus_tpu.ops.pallas.nn import build_nn_target, chunk_boxes

    m, q = inputs["pallas_m"], inputs["pallas_q"]
    fake = tmesh.Mesh(1, SHARDS, 0, torch.device("cpu"), "gloo")
    assert tsm.pallas_shardable(fake, SHARDS * BT) and not tsm.pallas_shardable(fake, SHARDS * BT // 2)
    assert jsm.pallas_shardable(mesh8, SHARDS * BT, "map")
    ref = np.linalg.norm(q[:, None] - m[None], axis=-1) ** 2
    np.testing.assert_array_equal(ranks[0]["pallas_idx"], np.argmin(ref, axis=1))
    np.testing.assert_allclose(ranks[0]["pallas_d2"], ref.min(axis=1), rtol=1e-4, atol=1e-5)
    xyz = jnp.asarray(m)
    aug = build_nn_target(xyz)
    c_min, c_max = chunk_boxes(xyz, jnp.ones((m.shape[0],), bool), aug.shape[1])
    jd2, jidx = jsm.sharded_nearest_pallas(mesh8, jnp.asarray(q), xyz, aug, c_min, c_max, radius=50.0)
    np.testing.assert_array_equal(ranks[0]["pallas_idx"], np.asarray(jidx))
    np.testing.assert_allclose(ranks[0]["pallas_d2"], np.asarray(jd2), rtol=1e-4, atol=1e-5)
    jfar, _ = jsm.sharded_nearest_pallas(mesh8, jnp.asarray(q + 1000.0), xyz, aug, c_min, c_max, radius=2.0)
    assert np.all(np.isinf(ranks[0]["pallas_far_d2"])) and np.all(np.isinf(np.asarray(jfar)))


def _small(map_capacity, scan_capacity=256):
    return LocusConfig(scan_capacity=scan_capacity, raw_scan_capacity=1024, points_to_process_in_callback=200,
                       filtering=FilterConfig(normals_k=8),
                       mapper=MapperConfig(map_capacity=map_capacity, keyframe_capacity=256, map_voxel_leaf=0.1))


@pytest.mark.parametrize("structure", ["ring", "voxel_hash"])
@pytest.mark.parametrize("batched", [False, True])
def test_state_shard_specs_match_jax(structure, batched):
    """The split of every leaf equals JAX's `state_pspecs` (the port's 1-NN
    operand is (m_pad, 4), split by rows where JAX's (AUG, m_pad) splits by
    columns), also where a leaf outside the map has the map's capacity."""
    cap = 2 * BT
    jcfg = _small(cap, scan_capacity=cap)        # the scan-to-scan reference is (cap, 3): it stays whole
    jcfg = jcfg.replace(mapper=dataclasses.replace(jcfg.mapper, structure=structure))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jst, tst = jpl.init_state(jcfg), tpl.init_state(tcfg, device="cpu")
    if batched:
        jst = jax.tree_util.tree_map(lambda *x: jnp.stack(x), jst, jst)
        tst = tpl.stack_states([tst, tst])
    jspecs = jax.tree_util.tree_leaves(jmesh.state_pspecs(jst, cap, 2, batched=batched),
                                       is_leaf=lambda x: isinstance(x, P))
    tspecs = [s for _, s in tmesh.leaf_specs(tst, tmesh.state_shard_specs(tst, cap, 2, batched=batched))]
    lead = ("data",) if batched else ()
    want = [lead + ("map",) if tuple(s) == lead + (None, "map") else tuple(s) for s in jspecs]
    assert tspecs == want
    assert tspecs.count(lead + ("map",)) >= 7 and tst.odom.reference.xyz.shape[-2] == cap
    with pytest.raises(ValueError, match="multiple of"):
        tmesh.state_shard_specs(tst, cap, 4, batched=batched)
    with pytest.raises(ValueError, match="multiple of"):
        jmesh.state_pspecs(jst, cap, 4, batched=batched)


def test_shard_and_gather_state_round_trip():
    """`shard_state` cuts what `gather_state` joins: on a one-rank mesh the
    whole state comes back; a state cut for 2 shards holds half the map."""
    tst = tpl.init_state(config_from_dict(dataclasses.asdict(_small(2 * BT))), device="cpu")
    one = tmesh.make_mesh(1, device_type="cpu")
    back = tmesh.gather_state(one, tmesh.shard_state(one, tst, 2 * BT), 2 * BT)
    for (_, a), (_, b) in zip(tckpt.leaves_with_paths(tst), tckpt.leaves_with_paths(back)):
        assert torch.equal(a, b)
    half = tmesh.shard_state(tmesh.Mesh(1, 2, 1, torch.device("cpu"), "gloo"), tst, 2 * BT)
    assert half.map.cloud.capacity == BT and half.map.nn_aug.shape == (BT, 4) and half.map.chunk_min.shape == (1, 3)
    assert half.odom.reference.capacity == tst.odom.reference.capacity


def test_optimize_sharded_matches(inputs, ranks, mesh8):
    g = tpg.make_graph(inputs["pg_est"], inputs["pg_fi"], inputs["pg_fj"], inputs["pg_fT"],
                       factor_mask=inputs["pg_mask"], device="cpu")
    ref = tpg.optimize(g, iterations=8, cg_iterations=30)
    np.testing.assert_allclose(ranks[0]["pg_poses"], np_(ref.poses), atol=5e-3)
    jg = jpg.make_graph(inputs["pg_est"], inputs["pg_fi"].astype(np.int32), inputs["pg_fj"].astype(np.int32),
                        inputs["pg_fT"], factor_mask=inputs["pg_mask"])
    jshd = jpg.optimize_sharded(mesh8, jg, iterations=8, cg_iterations=30, axis="map")
    np.testing.assert_allclose(ranks[0]["pg_poses"], np.asarray(jshd.poses), atol=5e-3)


def test_sharded_insert_and_reanchor_match_single(inputs, ranks):
    """tests/test_parallel.py::test_sharded_reanchor_matches_single on the
    port: three keyframes inserted into a map split 4 ways (each shard
    writes the ring slots it owns), then re-anchored shard by shard; the
    gathered map equals the unsharded one's inserts and re-anchor bit for
    bit, and map_size sums the shards' counts."""
    cap = int(inputs["map_capacity"])
    mcfg = TMapperConfig(map_capacity=cap, keyframe_capacity=256, map_voxel_leaf=0.05)
    mp = tkm.init_map(mcfg, device="cpu")
    for k in range(3):
        mp = tkm.insert_keyframe(mp, PointCloud.from_points(inputs["kf_points"][k], capacity=256), mcfg)
    moved = tkm.reanchor(mp, torch.from_numpy(inputs["corrections"]), mcfg)
    assert int(ranks[0]["map_size"]) == int(tkm.map_size(mp)) > 0
    for name, m in (("inserted", mp), ("reanchored", moved)):
        for f in ("xyz", "normals", "mask"):
            np.testing.assert_array_equal(ranks[0][f"{name}_{f}"], np_(getattr(m.cloud, f)), err_msg=f"{name} {f}")
        for f in ("nn_aug", "chunk_min", "chunk_max", "kf_index", "write_ptr"):
            np.testing.assert_array_equal(ranks[0][f"{name}_{f}"], np_(getattr(m, f)), err_msg=f"{name} {f}")
    assert not np.array_equal(ranks[0]["reanchored_xyz"], ranks[0]["inserted_xyz"])


def test_sharded_checkpoint_round_trip(ranks):
    """Every leaf of every rank's shard comes back bit for bit; the same
    files read as another layout raise."""
    for out in ranks:
        assert out["ckpt_leaves_equal"].all()
        assert "same mesh" in str(out["ckpt_layout_error"])


def test_mesh_argument_checks():
    """Checks that need no process group: NCCL asked for more ranks than
    visible devices, a world that does not split into map columns, a
    `mesh=` that is not a mesh, factors that do not split over the ranks."""
    with pytest.raises(ValueError, match="NCCL"):
        tmesh.make_mesh(2, map_parallel=2, device_type="cuda", backend="nccl")
    with pytest.raises(ValueError, match="map columns"):
        tmesh.make_mesh(3, map_parallel=2, device_type="cpu")
    one = tmesh.make_mesh(1, device_type="cpu")
    assert one.shape == {"data": 1, "map": 1} and one.group("map") is None and one.backend == "gloo"
    _, est, fi, fj, fT = chain_graph(n=6)
    g = tpg.make_graph(est, fi, fj, fT, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tpg.optimize_sharded(object(), g)
    with pytest.raises(ValueError, match="factors"):
        tpg.optimize_sharded(tmesh.Mesh(1, 4, 0, torch.device("cpu"), "gloo"), g)    # 6 factors over 4
    np.testing.assert_array_equal(np_(tpg.optimize_sharded(one, g, iterations=2).poses),
                                  np_(tpg.optimize(g, iterations=2).poses))


def test_local_batch_slice():
    """tools/dist_smoke.py's host-role feeding: each data row feeds its own
    slice of the batch, the ranks of a row the same one."""
    rows = [tdist.local_batch_slice(tmesh.Mesh(2, 2, r, torch.device("cpu"), "gloo"), 4) for r in range(4)]
    assert rows == [[0, 1], [0, 1], [2, 3], [2, 3]]
    with pytest.raises(ValueError, match="split"):
        tdist.local_batch_slice(tmesh.Mesh(2, 1, 0, torch.device("cpu"), "gloo"), 3)


def test_two_rank_collective_and_host_roles(tmp_path):
    """tests/test_parallel.py::test_two_process_distributed_smoke on the
    port: two processes gather in rank order and split the batch by host
    role."""
    res = launch_tool(tmp_path, 2, "--mode", "sum")
    assert res["processes"] == 2 and res["collective_sum"] == 4.0
    assert res["local_batch_slice"] == [0] and [r["local_batch_slice"] for r in res["ranks"]] == [[0], [1]]
