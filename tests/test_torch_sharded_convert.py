"""`convert.state_from_sharded_checkpoint`: the port resumes from the files
of the JAX package's `checkpoint.save_state_sharded`.

The JAX state (a keyframe inserted, as tests/test_mapping.py's sharded
round trip) is written on the 8-device virtual CPU mesh of
tests/conftest.py with its map over 2 shards. Tolerance: none; every leaf
read back equals `convert.state_from_numpy` of the same JAX state bit for
bit, whole, on a 1-rank mesh and as each rank's shards of a 2-shard mesh,
also when the shards are spread over several process files. A missing
process file, a missing range and two different copies of one range
raise."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from locus_tpu import checkpoint as jckpt
from locus_tpu import pipeline as jpl
from locus_tpu.config import FilterConfig, FusionConfig, LocusConfig, MapperConfig
from locus_tpu.mapping import keyframe_map as jkm
from locus_tpu.parallel import mesh as jmesh
from locus_tpu_torch import runner as trunner
from locus_tpu_torch.checkpoint import leaves_with_paths
from locus_tpu_torch.convert import config_from_dict, state_from_numpy, state_from_sharded_checkpoint
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_state
from tests import torch_helpers  # noqa: F401  (caps torch's threads)
from tests.test_mapping import grid_cloud

JCFG = LocusConfig(
    scan_capacity=256,
    raw_scan_capacity=1024,
    points_to_process_in_callback=200,
    filtering=FilterConfig(normals_k=8),
    mapper=MapperConfig(map_capacity=4096, keyframe_capacity=256, map_voxel_leaf=0.1),
    fusion=FusionConfig(data_integration_mode=0),
)
TCFG = config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(checkpoint prefix, the JAX state with numpy leaves)."""
    mesh = jmesh.make_mesh(8, map_parallel=2)
    st = jpl.init_state(JCFG)
    st = st._replace(map=jkm.insert_keyframe(st.map, grid_cloud(0.0, n=100, capacity=256), JCFG.mapper))
    st = jax.tree_util.tree_map(
        jax.device_put, st, jmesh.single_state_shardings(mesh, st, JCFG.mapper.map_capacity))
    pfx = str(tmp_path_factory.mktemp("ck") / "ck")
    jckpt.save_state_sharded(pfx, st)
    return pfx, jax.tree_util.tree_map(np.asarray, st)


def assert_states_equal(a, b):
    for (name, x), (_, y) in zip(leaves_with_paths(a), leaves_with_paths(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


def test_whole_state_equals_the_unsharded_conversion(written):
    pfx, jstate = written
    ref = state_from_numpy(jstate, "cpu")
    got = state_from_sharded_checkpoint(pfx, TCFG, device="cpu")
    assert int(got.map.cloud.mask.sum()) == 100
    assert_states_equal(got, ref)
    one = make_mesh(1, device_type="cpu")
    assert_states_equal(state_from_sharded_checkpoint(pfx, TCFG, mesh=one, device="cpu"),
                        shard_state(one, ref, TCFG.mapper.map_capacity))


@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_of_a_two_shard_mesh_gets_its_shards(written, rank):
    pfx, jstate = written
    mesh = Mesh(1, 2, rank, torch.device("cpu"), "gloo")
    got = state_from_sharded_checkpoint(pfx, TCFG, mesh=mesh, device="cpu")
    assert got.map.cloud.capacity == TCFG.mapper.map_capacity // 2
    assert_states_equal(got, shard_state(mesh, state_from_numpy(jstate, "cpu"), TCFG.mapper.map_capacity))


def _split(pfx, out, parts):
    """The shards of the one process file spread over `parts` files, shard
    j of each leaf in file j % parts (renumbered per file)."""
    with np.load(pfx + ".proc0.npz") as z:
        files = [dict() for _ in range(parts)]
        counts = [dict() for _ in range(parts)]
        for key in z.files:
            if not key.endswith("_data"):
                continue
            leaf, shard = key.split("_")[1], int(key.split("_")[3])
            f = shard % parts
            j = counts[f].get(leaf, 0)
            counts[f][leaf] = j + 1
            files[f][f"leaf_{leaf}_shard_{j}_data"] = z[key]
            files[f][f"leaf_{leaf}_shard_{j}_index"] = z[key[:-5] + "_index"]
    for k, payload in enumerate(files):
        np.savez(f"{out}.proc{k}.npz", **payload)


def test_shards_spread_over_process_files(written, tmp_path):
    pfx, jstate = written
    out = str(tmp_path / "split")
    _split(pfx, out, 2)
    assert_states_equal(state_from_sharded_checkpoint(out, TCFG, device="cpu"), state_from_numpy(jstate, "cpu"))


def test_resume_steps_like_the_unsharded_conversion(written):
    pfx, jstate = written
    seq = make_tunnel_sequence(num_scans=2, azimuth_steps=128, step=0.3, seed=2)
    poses = []
    for st in (state_from_sharded_checkpoint(pfx, TCFG, device="cpu"), state_from_numpy(jstate, "cpu")):
        for i in range(2):
            st, out = trunner.replay_step(st, *trunner.scan_inputs(seq, i, TCFG, "cpu"), cfg=TCFG)
        poses.append(out.pose.numpy())
    np.testing.assert_array_equal(poses[0], poses[1])


def test_missing_process_file_raises(written, tmp_path):
    pfx, _ = written
    out = str(tmp_path / "gap")
    _split(pfx, out, 3)
    (tmp_path / "gap.proc1.npz").unlink()
    with pytest.raises(ValueError, match="processes \\[1\\]"):
        state_from_sharded_checkpoint(out, TCFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        state_from_sharded_checkpoint(str(tmp_path / "none"), TCFG, device="cpu")


def _rewrite(pfx, out, edit):
    with np.load(pfx + ".proc0.npz") as z:
        payload = {k: z[k] for k in z.files}
    edit(payload)
    np.savez(out + ".proc0.npz", **payload)


def _map_xyz_leaf(template):
    return next(i for i, (name, _) in enumerate(leaves_with_paths(template)) if name == ("map", "cloud", "xyz"))


def test_missing_range_raises(written, tmp_path):
    pfx, _ = written
    leaf = _map_xyz_leaf(state_from_numpy(written[1], "cpu"))
    out = str(tmp_path / "hole")

    def drop_last_shard(p):
        last = max(int(k.split("_")[3]) for k in p if k.startswith(f"leaf_{leaf}_shard_"))
        del p[f"leaf_{leaf}_shard_{last}_data"], p[f"leaf_{leaf}_shard_{last}_index"]

    _rewrite(pfx, out, drop_last_shard)
    with pytest.raises(ValueError, match=r"leaf \d+ \(map\.cloud\.xyz\).*in no shard"):
        state_from_sharded_checkpoint(out, TCFG, device="cpu")


def test_conflicting_copies_of_a_range_raise(written, tmp_path):
    pfx, _ = written
    leaf = _map_xyz_leaf(state_from_numpy(written[1], "cpu"))
    out = str(tmp_path / "twice")

    def add_conflicting_copy(p):
        n = sum(1 for k in p if k.startswith(f"leaf_{leaf}_shard_") and k.endswith("_data"))
        p[f"leaf_{leaf}_shard_{n}_data"] = p[f"leaf_{leaf}_shard_0_data"] + 1.0
        p[f"leaf_{leaf}_shard_{n}_index"] = p[f"leaf_{leaf}_shard_0_index"]

    _rewrite(pfx, out, add_conflicting_copy)
    with pytest.raises(ValueError, match="different data"):
        state_from_sharded_checkpoint(out, TCFG, device="cpu")
