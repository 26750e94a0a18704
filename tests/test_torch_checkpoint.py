"""The port's checkpoint (`locus_tpu_torch/checkpoint.py`) and the reading
of the JAX package's checkpoints (`convert.state_from_checkpoint`).

- A port checkpoint round-trips every leaf bit for bit, and a replay
  resumed from it continues bit for bit as the uninterrupted one (the
  CPU port is deterministic).
- A template of another config raises ValueError, as in JAX's
  test_checkpoint_shape_mismatch.
- The JAX package runs 3 scans and checkpoints; the port resumes from
  that file and its next 3 scans match JAX's within the replay tolerance
  of tests/test_torch_pipeline.py (1e-2 m, 1e-2 rad), keyframe decisions
  equal; the loaded state equals JAX's leaf for leaf (the map operand in
  the port's layout).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import checkpoint as jckpt
from locus_tpu import pipeline as jpl
from locus_tpu import runner as jrunner
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu_torch import checkpoint as tckpt
from locus_tpu_torch import pipeline as tpl
from locus_tpu_torch import runner as trunner
from locus_tpu_torch.convert import config_from_dict, state_from_checkpoint
from locus_tpu_torch.io.dataset import Sequence as TSequence
from tests.test_aux import small_cfg
from tests.torch_helpers import np_, pose_diff

POSE_TOL_M = POSE_TOL_RAD = 1e-2


@pytest.fixture(scope="module")
def seq():
    return make_tunnel_sequence(num_scans=6, azimuth_steps=256, step=0.3, seed=2)


def _tseq(seq):
    return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})


def _port_run(state, seq, cfg, lo, hi):
    poses = []
    for i in range(lo, hi):
        state, out = trunner.replay_step(state, *trunner.scan_inputs(_tseq(seq), i, cfg, "cpu"), cfg=cfg)
        poses.append(out.pose.numpy())
    return state, poses


def _init(cfg, seq):
    return tpl.init_state(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device="cpu")


def test_checkpoint_roundtrip_is_bit_exact(tmp_path, seq):
    cfg = config_from_dict(dataclasses.asdict(small_cfg()))
    state, _ = _port_run(_init(cfg, seq), seq, cfg, 0, 3)
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, state)
    restored = tckpt.load_state(path, tpl.init_state(cfg, device="cpu"))
    for (name, a), (_, b) in zip(tckpt.leaves_with_paths(state), tckpt.leaves_with_paths(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    _, straight = _port_run(state, seq, cfg, 3, 6)
    _, resumed = _port_run(restored, seq, cfg, 3, 6)
    for a, b in zip(straight, resumed):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_shape_mismatch(tmp_path):
    cfg = config_from_dict(dataclasses.asdict(small_cfg()))
    path = str(tmp_path / "s.npz")
    tckpt.save_state(path, tpl.init_state(cfg, device="cpu"))
    other = tpl.init_state(cfg.replace(scan_capacity=512), device="cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        tckpt.load_state(path, other)


def test_sharded_checkpoints_raise():
    with pytest.raises(NotImplementedError, match="A16"):
        tckpt.save_state_sharded("x", None)
    with pytest.raises(NotImplementedError, match="A16"):
        tckpt.load_state_sharded("x", None)


def test_port_resumes_from_a_jax_checkpoint(tmp_path, seq):
    jcfg = small_cfg()
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    rstep = jrunner.make_replay_step(jcfg)
    jst = jpl.init_state(jcfg, initial_pose=jnp.asarray(seq.gt_poses[0], jnp.float32))
    jst = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jst)
    jposes, jkf = [], []
    for i in range(6):
        if i == 3:
            path = str(tmp_path / "jax.npz")
            jckpt.save_state(path, jst)
            tst = state_from_checkpoint(path, tcfg, "cpu")
            jleaves = jax.tree_util.tree_leaves(jst)
            for (name, t), j in zip(tckpt.leaves_with_paths(tst), jleaves):
                j = np_(j)
                if name[-1] == "nn_aug":
                    j = j[:4].T
                np.testing.assert_array_equal(np_(t), j, err_msg=str(name))
        args = trunner.scan_inputs(_tseq(seq), i, tcfg, "cpu")
        jst, jout = rstep(jst, *[jnp.asarray(a.numpy()) for a in args])
        if i >= 3:
            jposes.append(np_(jout.pose))
            jkf.append(bool(jout.keyframe_inserted))
    tposes, tkf = [], []
    for i in range(3, 6):
        tst, tout = trunner.replay_step(tst, *trunner.scan_inputs(_tseq(seq), i, tcfg, "cpu"), cfg=tcfg)
        tposes.append(tout.pose.numpy())
        tkf.append(bool(tout.keyframe_inserted))
    for a, b in zip(tposes, jposes):
        dt, dr = pose_diff(a, b)
        assert dt < POSE_TOL_M and dr < POSE_TOL_RAD, (dt, dr)
    assert tkf == jkf
