"""The port's sharded replays (`runner.make_scan_replay(mesh=)`,
`make_batched_replay(mesh=)`, the sharded checkpoint) on gloo ranks on
the CPU (tools/torch_dist_smoke.py through tests/torch_ranks.py), against
its own unsharded replays and the JAX package: the cases of
tests/test_parallel.py's sharded replays and two-process deployments.

Tolerances:
- each sharded replay against the port's unsharded replay of the same
  scans: within 1e-4 m (JAX's own bound) with equal map sizes on every
  scan, and in fact bit for bit (`bit_equal`: the shards' winners merge
  to the whole map's, ties to the lowest shard, and the sums do not
  depend on the layout), on the ring map, the voxel hash, with the map
  sliding window evicting, and on a map axis of 1;
- the sharded kill-resume against the uninterrupted replay: bit for bit;
- the port's 2-rank sharded replay against JAX's
  `make_scan_replay(mesh=make_mesh(8, map_parallel=2))` on the same
  tunnel: within 1e-2 m / 1e-2 rad a scan and map sizes within 0.5 %, the
  port's single-replay tolerance against JAX
  (tests/test_torch_pipeline.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import pipeline as jpl
from locus_tpu.config import FilterConfig, FusionConfig, LocusConfig, MapperConfig
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu.parallel import mesh as jmesh
from locus_tpu.runner import make_scan_replay as jreplay, pack_sequence as jpack
from locus_tpu_torch import pipeline, runner
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.io.dataset import Sequence as TSequence
from locus_tpu_torch.parallel import mesh as tmesh
from tests.test_pipeline import small_cfg
from tests.torch_helpers import np_, pose_diff
from tests.torch_ranks import launch_tool

SINGLE_TOL_M = 1e-4
JAX_TOL_M = JAX_TOL_RAD = 1e-2
MAP_SIZE_RTOL = 5e-3


# The tool's "ci" profile (tools/live_endurance.py --ci's shapes) with a
# 4096-slot map: 2 shards of one B2 chunk, and 1024-point keyframes, so the
# ring runs into the second shard by scan 6 (tools/dist_smoke.py's config
# fills only the first shard in 8 scans). Ten 256-azimuth tunnel scans.
CI = ("--profile", "ci", "--map-capacity", "4096", "--scans", "10", "--azimuth", "256")


def ci_cfg():
    return LocusConfig(
        scan_capacity=1024, raw_scan_capacity=8192, points_to_process_in_callback=800,
        filtering=FilterConfig(normals_k=12),
        mapper=MapperConfig(map_capacity=4096, keyframe_capacity=1024, map_voxel_leaf=0.15),
    )


def _assert_sharded_equals_single(res):
    assert res["max_pose_err"] < SINGLE_TOL_M and res["map_sizes_equal"] is True, res
    assert res["bit_equal"] is True and res["map_sizes_agree_across_ranks"] is True
    assert res["final_map_size"] > 0


def test_sharded_replay_matches_single_and_jax(tmp_path):
    """tests/test_parallel.py::test_two_process_pipeline_replay on the port
    (2 ranks, the map split over both, each shard 2 B2 chunks), then the
    same tunnel through JAX's whole-step shard_map replay: small_cfg on
    test_torch_pipeline.py's 12-scan tunnel, where the port's unsharded
    replay is held to JAX's within the same tolerance."""
    res = launch_tool(tmp_path, 2, "--mode", "pipeline", "--profile", "small", "--scans", 12, "--azimuth", 256,
                      "--step", 0.3, "--seed", 1)
    _assert_sharded_equals_single(res)
    assert res["mesh"] == {"data": 1, "map": 2}
    assert [r["map_operand_rows"] for r in res["ranks"]] == [4096, 4096]
    with np.load(tmp_path / "pipeline_poses.npz") as z:
        poses, sizes = z["poses"], z["sizes"]

    jcfg = small_cfg()
    seq = make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3, seed=1)
    mesh = jmesh.make_mesh(8, map_parallel=2)
    st = jpl.init_state(jcfg, jnp.asarray(seq.gt_poses[0], jnp.float32))
    st = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), st)
    st = jax.tree_util.tree_map(jax.device_put, st, jmesh.single_state_shardings(mesh, st, jcfg.mapper.map_capacity))
    _, (jposes, _, jsizes) = jreplay(jcfg, mesh=mesh)(st, jpack(seq, jcfg))
    for i, (a, b) in enumerate(zip(poses, np.asarray(jposes))):
        dt, dr = pose_diff(a, b)
        assert dt < JAX_TOL_M and dr < JAX_TOL_RAD, (i, dt, dr)
    np.testing.assert_allclose(sizes, np.asarray(jsizes), rtol=MAP_SIZE_RTOL)


@pytest.mark.parametrize("case,args", [
    # tests/test_parallel.py::test_sharded_replay_voxel_hash_matches_single:
    # the owner test of the same-voxel slots, OR-ed over the shards
    ("voxel_hash", CI + ("--structure", "voxel_hash")),
    # ::test_sharded_msw_refresh_and_eviction_matches_single: an 8 m window
    # whose refresh fires and evicts within 12 scans (JAX's 5 m window
    # empties this config's map)
    ("msw_eviction", CI + ("--msw-box", "8.0", "--scans", "12", "--step", "0.5", "--seed", "7")),
    # ::test_scan_replay_degenerate_mesh_map1: a map axis of 1, every rank
    # a whole replica, no collective
    ("map1", CI + ("--map-parallel", "1")),
])
def test_sharded_replay_configs_match_single(tmp_path, case, args):
    res = launch_tool(tmp_path, 2, "--mode", "pipeline", *args)
    if case != "map1":
        assert all(r["local_map_points"] > 0 for r in res["ranks"]), res["ranks"]
    _assert_sharded_equals_single(res)
    sizes = res["ranks"][0]["map_sizes"]
    if case == "msw_eviction":
        assert max(sizes) > sizes[-1], sizes          # the refresh evicted
    if case == "map1":
        assert res["mesh"] == {"data": 2, "map": 1}
        assert all(r["local_map_points"] == res["final_map_size"] for r in res["ranks"])


@pytest.mark.parametrize("world,map_parallel", [(2, 1), (4, 2)])
def test_dp_replay_with_host_role_feeding(tmp_path, world, map_parallel):
    """tests/test_parallel.py::test_two_process_dp_replay_with_host_role_feeding
    and ::test_map_sharding_determinism on the port: two robots split over
    the data rows, each rank packing only its own, each robot's map split
    over the map columns (world 4: a (2, 2) mesh); every robot equal to its
    unsharded replay."""
    res = launch_tool(tmp_path, world, "--mode", "dp", "--map-parallel", map_parallel, "--robots", 2, *CI)
    assert res["mesh"] == {"data": 2, "map": map_parallel}
    assert res["owned_rows"] == [[r // map_parallel] for r in range(world)]
    assert res["max_pose_err"] < SINGLE_TOL_M and res["bit_equal"] is True, res
    assert all(s[0] > 0 for s in res["final_map_sizes"])
    if map_parallel == 2:
        assert all(r["map_operand_rows"] == 2048 for r in res["ranks"])


def test_two_rank_checkpoint_kill_resume(tmp_path):
    """tests/test_parallel.py::test_two_process_checkpoint_kill_resume on the
    port: 2 ranks replay 4 scans of the sharded map, each saves only its own
    shards and exits; 2 fresh ranks restore their files and replay the last
    4 scans, bit for bit the uninterrupted replay."""
    ckpt = str(tmp_path / "ck")
    saved = launch_tool(tmp_path, 2, "--mode", "ckpt_save", "--ckpt", ckpt, "--resume-at", 5, *CI)
    assert saved["scans_before_kill"] == 5
    assert saved["wrote"] == [f"{ckpt}.proc0.npz", f"{ckpt}.proc1.npz"]
    assert (tmp_path / "ck.proc0.npz").exists() and (tmp_path / "ck.proc1.npz").exists()
    res = launch_tool(tmp_path, 2, "--mode", "ckpt_resume", "--ckpt", ckpt, "--resume-at", 5, *CI)
    assert res["resumed_scans"] == 5
    _assert_sharded_equals_single(res)
    assert all(r["local_map_points"] > 0 for r in res["ranks"])


def test_one_rank_mesh_and_argument_checks():
    """A one-rank mesh replays as the unsharded path; `mesh=` that is not a
    mesh raises TypeError, a map that does not tile into whole B2 chunks a
    shard ValueError, and so does a state that was not cut to its shard."""
    cfg = config_from_dict(dataclasses.asdict(ci_cfg()))
    jseq = make_tunnel_sequence(num_scans=2, azimuth_steps=64, seed=3)
    seq = TSequence(**{f.name: getattr(jseq, f.name) for f in dataclasses.fields(TSequence)})
    packed = runner.pack_sequence(seq, cfg, device="cpu")

    def fresh():
        return pipeline.init_state(cfg, torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device="cpu")

    one = tmesh.make_mesh(1, device_type="cpu")
    a = runner.make_scan_replay(cfg, mesh=one)(fresh(), packed)[1][0]
    b = runner.make_scan_replay(cfg)(fresh(), packed)[1][0]
    np.testing.assert_array_equal(np_(a), np_(b))
    two = tmesh.Mesh(1, 2, 0, torch.device("cpu"), "gloo")      # no process group: only the checks run
    with pytest.raises(ValueError, match="shard_state"):
        runner.make_scan_replay(cfg, mesh=two)(fresh(), packed)
    small = cfg.replace(mapper=dataclasses.replace(cfg.mapper, map_capacity=6144))
    for make in (runner.make_scan_replay, runner.make_batched_replay):
        with pytest.raises(TypeError, match="Mesh"):
            make(cfg, mesh=object())
        with pytest.raises(ValueError, match="multiple of"):
            make(small, mesh=two)
    with pytest.raises(TypeError, match="Mesh"):
        runner.make_live_step(cfg, 16, 4, mesh="map")
