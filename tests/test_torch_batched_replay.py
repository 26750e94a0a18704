"""The port's batched multi-robot replay against its own single replay and
against the JAX package.

(a) `make_batched_replay` against the port's `make_scan_replay`, robot by
    robot: within 1e-4 m (JAX's own bound, tests/test_parallel.py:191; the
    port reaches 0.0, it sums in the same order batched and single).
(b) `make_batched_replay` against JAX's `make_batched_replay` at the config
    of tests/test_parallel.py:160-168: within 1e-2 m / 1e-2 rad per scan,
    PR 1's port-vs-JAX bound (ROADMAP §C: the GICP loops that end on
    their cap amplify f32 rounding).
(c) `MultiRobotSession` against JAX's at tests/test_live.py:238-243's
    sizes, with the same tolerance as (b).
(d) A stacked JAX state converts to the port's batched state exactly.
(e) The state initialisers take the card unless asked for the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import pipeline as jpl
from locus_tpu import runner as jrunner
from locus_tpu.config import FilterConfig, LocusConfig, MapperConfig
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu.live import MultiRobotSession as JMulti
from locus_tpu_torch import fusion, localization, odometry, pipeline, runner
from locus_tpu_torch.convert import config_from_dict, state_from_numpy
from locus_tpu_torch.io.dataset import Sequence as TSequence
from locus_tpu_torch.live import MultiRobotSession
from locus_tpu_torch.mapping import keyframe_map
from tests.test_pipeline import small_cfg
from tests.torch_helpers import np_, pose_diff

SINGLE_TOL_M = 1e-4
JAX_TOL_M = 1e-2
JAX_TOL_RAD = 1e-2


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _port_seq(seq):
    return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})


def _assert_close_to_jax(tp, jp):
    for i, (a, b) in enumerate(zip(tp, jp)):
        dt, dr = pose_diff(a, b)
        assert dt < JAX_TOL_M and dr < JAX_TOL_RAD, (i, dt, dr)


@pytest.fixture(scope="module")
def parallel_case():
    """tests/test_parallel.py::test_batched_multisequence_replay's config
    and sequences."""
    jcfg = LocusConfig(
        scan_capacity=256,
        raw_scan_capacity=1024,
        points_to_process_in_callback=200,
        filtering=FilterConfig(normals_k=8),
        mapper=MapperConfig(map_capacity=2048, keyframe_capacity=256, map_voxel_leaf=0.1),
    )
    seqs = [make_tunnel_sequence(num_scans=3, azimuth_steps=64, seed=s) for s in (0, 1)]
    return jcfg, seqs


def test_batched_replay_matches_single_and_jax(parallel_case):
    jcfg, seqs = parallel_case
    cfg = _port_cfg(jcfg)
    packed = [runner.pack_sequence(_port_seq(s), cfg, device="cpu") for s in seqs]
    single = runner.make_scan_replay(cfg)
    ref = []
    for s, p in zip(seqs, packed):
        st = pipeline.init_state(cfg, initial_pose=torch.as_tensor(s.gt_poses[0], dtype=torch.float32), device="cpu")
        ref.append(np_(single(st, p)[1][0]))
    states = pipeline.init_states(cfg, np.stack([s.gt_poses[0] for s in seqs]), device="cpu")
    _, (poses, cond, sizes) = runner.make_batched_replay(cfg)(states, runner.stack_packed(packed))
    assert poses.shape == (3, 2, 4, 4) and cond.shape == sizes.shape == (3, 2)
    for b in range(2):
        np.testing.assert_allclose(np_(poses[:, b]), ref[b], atol=SINGLE_TOL_M, rtol=0)

    # JAX's batched replay (its XLA paths on the CPU)
    jstates = [jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                      jpl.init_state(jcfg, initial_pose=jnp.asarray(s.gt_poses[0], jnp.float32)))
               for s in seqs]
    jbatched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    jpacked = jrunner.stack_packed([jrunner.pack_sequence(s, jcfg) for s in seqs])
    _, (jposes, _, jsizes) = jrunner.make_batched_replay(jcfg)(jbatched, jpacked)
    jposes = np.asarray(jposes)
    for b in range(2):
        _assert_close_to_jax(np_(poses[:, b]), jposes[:, b])
    np.testing.assert_array_equal(np_(sizes), np.asarray(jsizes))


def test_batched_replay_options(parallel_case):
    """use_pallas=False runs the plain versions (the same poses on the
    CPU); `mesh=` takes a parallel.mesh.Mesh (TypeError otherwise) whose map
    columns split the map into whole B2 chunks (ValueError otherwise: this
    2048-slot map does not split over 2), and a one-rank mesh replays as the
    unsharded path."""
    jcfg, seqs = parallel_case
    cfg = _port_cfg(jcfg)
    packed = runner.stack_packed([runner.pack_sequence(_port_seq(s), cfg, max_scans=2, device="cpu") for s in seqs])
    init = np.stack([s.gt_poses[0] for s in seqs])
    a = runner.make_batched_replay(cfg)(pipeline.init_states(cfg, init, device="cpu"), packed)[1][0]
    b = runner.make_batched_replay(cfg, use_pallas=False)(pipeline.init_states(cfg, init, device="cpu"), packed)[1][0]
    np.testing.assert_array_equal(np_(a), np_(b))
    from locus_tpu_torch.parallel import mesh as tmesh

    two = tmesh.Mesh(1, 2, 0, torch.device("cpu"), "gloo")
    for make in (runner.make_batched_replay, runner.make_scan_replay):
        with pytest.raises(TypeError, match="Mesh"):
            make(cfg, mesh=object())
        with pytest.raises(ValueError, match="multiple of"):
            make(cfg, mesh=two)
    with pytest.raises(ValueError, match="multiple of"):
        tmesh.state_shard_specs(pipeline.init_states(cfg, init, device="cpu"), cfg.mapper.map_capacity, 2,
                                batched=True)
    c = runner.make_batched_replay(cfg, mesh=tmesh.make_mesh(1, device_type="cpu"))(
        pipeline.init_states(cfg, init, device="cpu"), packed)[1][0]
    np.testing.assert_array_equal(np_(c), np_(a))


def test_multi_robot_session_matches_jax():
    """tests/test_live.py::test_multi_robot_session_tracks_independently's
    robots, through both packages' MultiRobotSession, with IMU and wheel
    odometry fed to one robot."""
    seq_a = make_tunnel_sequence(num_scans=6, azimuth_steps=256, step=0.3, seed=2)
    seq_b = make_tunnel_sequence(num_scans=6, azimuth_steps=256, step=0.4, seed=9)
    jcfg = small_cfg()
    init = np.stack([seq_a.gt_poses[0], seq_b.gt_poses[0]])
    jm = JMulti(cfg=jcfg, num_robots=2, initial_poses=init)
    tm = MultiRobotSession(cfg=_port_cfg(jcfg), num_robots=2, initial_poses=init, device="cpu")
    jp, tp = [], []
    for i in range(6):
        for m in (jm, tm):
            m.feed_imu(0, seq_a.stamps[i] - 0.01, [1.0, 0.0, 0.0, 0.0])
            m.feed_odom(0, seq_a.stamps[i] - 0.01, seq_a.gt_poses[i])
        args = ([seq_a.stamps[i], seq_b.stamps[i]], [seq_a.scans[i], seq_b.scans[i]],
                [seq_a.scan_valid[i], seq_b.scan_valid[i]])
        jp.append(jm.process_scans(*args)[0])
        poses, outs = tm.process_scans(*args)
        tp.append(poses)
        assert outs.pose.shape == (2, 4, 4)
    jp, tp = np.stack(jp), np.stack(tp)
    for b in range(2):
        _assert_close_to_jax(tp[:, b], jp[:, b])


def test_stacked_state_converts_exactly(parallel_case):
    jcfg, seqs = parallel_case
    jstates = [jpl.init_state(jcfg, initial_pose=jnp.asarray(s.gt_poses[0], jnp.float32)) for s in seqs]
    jbatched = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *jstates)
    tst = state_from_numpy(jbatched, "cpu")
    assert tst.map.nn_aug.shape == (2, jstates[0].map.nn_aug.shape[1], 4)
    ours = pipeline.init_states(_port_cfg(jcfg), np.stack([s.gt_poses[0] for s in seqs]), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tuple(tst)), jax.tree_util.tree_leaves(tuple(ours))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np_(a), np_(b))


def test_state_initialisers_need_a_card_unless_asked(monkeypatch):
    cfg = _port_cfg(small_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "odometry": lambda **kw: odometry.init_state(cfg.scan_capacity, **kw),
        "fusion": lambda **kw: fusion.init_state(cfg.fusion, **kw),
        "localization": lambda **kw: localization.init_state(**kw),
        "keyframe_map": lambda **kw: keyframe_map.init_map(cfg.mapper, **kw),
        "init_states": lambda **kw: pipeline.init_states(cfg, num_robots=2, **kw),
        "pack_sequence": lambda **kw: runner.pack_sequence(
            _port_seq(make_tunnel_sequence(num_scans=1, azimuth_steps=64, seed=0)), cfg, **kw),
        "MultiRobotSession": lambda **kw: MultiRobotSession(cfg=cfg, **kw).states,
    }
    for name, make in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        leaves = jax.tree_util.tree_leaves(make(device="cpu"))
        assert leaves and all(x.device.type == "cpu" for x in leaves if isinstance(x, torch.Tensor)), name
