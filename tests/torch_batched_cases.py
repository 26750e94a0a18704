"""Shared cases of the `test_torch_batched_configs*.py` files: the port's
batched multi-robot step on every single-card configuration (ROADMAP
A15b), against its own single replay and against the JAX package's
`make_batched_replay` (a vmap of the JAX step).

Configurations (`config`, on small_cfg with the mode-3 prior, as in
test_torch_pipeline.py): NDT in both stages (irls; and newton with the
Moré–Thuente search), the LOAM features with adaptive covariances, the
voxel-hash map, keyframes at map resolution, the grid + random + outlier
+ radius filters, kNN normals with the recompute covariance mode, the
in-graph space monitor, and a stacked ground-truth-map bootstrap from a
PCD. Two robots, each on its own tunnel (azimuth 256), for SCANS scans.

(a) `make_batched_replay` against each robot's own `make_scan_replay`:
    the poses, condition numbers and map sizes, every step output
    (iteration counts, keyframe flags, point counts, ...) and the final
    state, bit for bit (`assert_array_equal`). The port sums in an order fixed by
    the shapes, so a robot rounds as it does alone.
(b) The same replay against JAX's `make_batched_replay` on the same
    stacked states and packed inputs (its XLA paths on the CPU): within
    1e-2 m / 1e-2 rad per scan (JAX_TOL_M, JAX_TOL_RAD of
    test_torch_batched_replay.py), the keyframe counts equal and the map
    sizes within MAP_SIZE_RTOL (0.5 %, test_torch_pipeline.py's
    port-vs-JAX bound: one novelty distance at the map leaf may round to
    the other side). The random filter draws from torch's generator,
    not the JAX PRNG, so the `filters` case is held to (a) only.
(c) `MultiRobotSession` on NDT against JAX's, with the tolerance of (b)
    (test_torch_batched_configs.py).

The cases are split over test files so that none runs long on one
worker; each file parametrises `check_matches_single` and
`check_matches_jax` over its own configurations.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from locus_tpu import pipeline as jpl
from locus_tpu import runner as jrunner
from locus_tpu.config import FusionConfig
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu_torch import pipeline, runner
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.io.dataset import Sequence as TSequence
from tests.test_pipeline import small_cfg
from tests.torch_helpers import np_, pose_diff

JAX_TOL_M = 1e-2
JAX_TOL_RAD = 1e-2
SCANS = 4
MAP_SIZE_RTOL = 5e-3
R = dataclasses.replace

# the random filter's draw is torch's, not JAX's: held to (a) only
NO_JAX = ("filters",)


def port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _port_seq(seq):
    return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})


def _both_stages(cfg, **kw):
    return cfg.replace(odometry=R(cfg.odometry, **kw),
                       localization=R(cfg.localization, registration=R(cfg.localization.registration, **kw)))


@functools.lru_cache(maxsize=None)
def sequences():
    """test_pipeline.py's 12-scan tunnel (step 0.3, seed 1), the sequence
    of test_torch_pipeline.py's port-vs-JAX bounds, and another at step
    0.4, seed 2; the replays take their first SCANS scans."""
    return tuple(make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=st, seed=s)
                 for st, s in ((0.3, 1), (0.4, 2)))


def write_gt_pcd(tmp_path_factory):
    """A prior map from every third point of both robots' first scans, in
    the world frame (no normals: kNN normals at load)."""
    from locus_tpu.io.pcd import write_pcd

    world = np.concatenate([
        s.scans[0][s.scan_valid[0]][::3] @ s.gt_poses[0][:3, :3].T + s.gt_poses[0][:3, 3] for s in sequences()
    ]).astype(np.float32)
    path = tmp_path_factory.mktemp("gt") / "map.pcd"
    write_pcd(str(path), world)
    return str(path)


def config(name, gt_path=None):
    """The JAX config of one case."""
    base = small_cfg(fusion=FusionConfig(data_integration_mode=3))
    f = base.filtering
    if name == "ndt":
        return _both_stages(base, registration_method="ndt")
    if name == "ndt_newton":
        return _both_stages(base, registration_method="ndt", ndt_optimizer="newton")
    if name == "features":
        return _both_stages(base.replace(filtering=R(f, extract_features=True, feature_width=256)),
                            covariance_mode="adaptive")
    if name == "voxel_hash":
        return base.replace(mapper=R(base.mapper, structure="voxel_hash"))
    if name == "keyframe_at_map_resolution":
        return base.replace(mapper=R(base.mapper, keyframe_at_map_resolution=True))
    if name == "filters":
        return base.replace(filtering=R(f, grid_filter=True, random_filter=True, outlier_filter=True,
                                        radius_filter=True, radius=0.8, radius_knn=3))
    if name == "knn_recompute":
        return _both_stages(base.replace(filtering=R(f, normals_method="knn")), covariance_mode="recompute")
    if name == "space_monitor":
        return base.replace(b_monitor_space=True, xy_cross_section_threshold=100.0)
    assert name == "gt_map"
    return base.replace(b_run_with_gt_point_cloud=True, gt_point_cloud_filename=gt_path,
                        b_add_keyframes_enabled=False)


def _port_runs(jcfg):
    """The port's batched replay and each robot's single replay on the
    CPU: ((final state, (poses, cond, sizes)), step outputs) each."""
    cfg = port_cfg(jcfg)
    seqs = [_port_seq(s) for s in sequences()]
    packed = [runner.pack_sequence(s, cfg, max_scans=SCANS, device="cpu") for s in seqs]
    init = np.stack([s.gt_poses[0] for s in seqs])
    outs = []
    batched = runner.make_batched_replay(cfg)(
        pipeline.init_states(cfg, init, device="cpu"), runner.stack_packed(packed), outputs=outs
    )
    singles = []
    for s, p in zip(seqs, packed):
        st = pipeline.init_state_from_config(cfg, torch.as_tensor(s.gt_poses[0], dtype=torch.float32), device="cpu")
        souts = []
        singles.append((runner.make_scan_replay(cfg)(st, p, outputs=souts), pipeline.stack_states(souts)))
    return (batched, pipeline.stack_states(outs)), singles


@functools.lru_cache(maxsize=None)
def port_runs(name, gt_path):
    return _port_runs(config(name, gt_path))


def gt_for(name, gt_pcd):
    return gt_pcd if name == "gt_map" else None


def _assert_equal_trees(a, b, what):
    for i, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))):
        np.testing.assert_array_equal(np_(x), np_(y), err_msg=f"{what}: leaf {i}")


def _assert_equal_trees(a, b, what):
    for i, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))):
        np.testing.assert_array_equal(np_(x), np_(y), err_msg=f"{what}: leaf {i}")


def check_matches_single(name, gt_pcd):
    """(a) bit for bit, robot by robot: the replay's poses, condition
    numbers and map sizes, every step output (iteration counts, keyframe
    flags, point counts, ...) and the final state."""
    ((states, (poses, cond, sizes)), bouts), singles = port_runs(name, gt_for(name, gt_pcd))
    assert poses.shape == (SCANS, 2, 4, 4)
    for b, ((sstate, (sposes, scond, ssizes)), souts) in enumerate(singles):
        np.testing.assert_array_equal(np_(poses[:, b]), np_(sposes))
        np.testing.assert_array_equal(np_(cond[:, b]), np_(scond))
        np.testing.assert_array_equal(np_(sizes[:, b]), np_(ssizes))
        _assert_equal_trees(pipeline.StepOutput(*(x[:, b] for x in bouts)), souts, f"{name} robot {b} outputs")
        _assert_equal_trees(pipeline.member(states, b), sstate, f"{name} robot {b} final state")
    assert bool(torch.isfinite(poses).all())
    assert not torch.equal(poses[:, 0], poses[:, 1])    # the robots are not copies of one another


def check_matches_jax(name, gt_pcd):
    """(b) against JAX's make_batched_replay on the same states and inputs."""
    jcfg = config(name, gt_for(name, gt_pcd))
    ((states, (poses, _, sizes)), _), _ = port_runs(name, gt_for(name, gt_pcd))
    jstates = [jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jpl.init_state_from_config(
        jcfg, initial_pose=jnp.asarray(s.gt_poses[0], jnp.float32))) for s in sequences()]
    jbatched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    jpacked = jrunner.stack_packed([jrunner.pack_sequence(s, jcfg, max_scans=SCANS) for s in sequences()])
    jfinal, (jposes, _, jsizes) = jrunner.make_batched_replay(jcfg)(jbatched, jpacked)
    jposes, jsizes = np.asarray(jposes), np.asarray(jsizes)
    for b in range(2):
        for i, (a, c) in enumerate(zip(np_(poses[:, b]), jposes[:, b])):
            dt, dr = pose_diff(a, c)
            assert dt < JAX_TOL_M and dr < JAX_TOL_RAD, (name, b, i, dt, dr)
    assert np.all(np.abs(np_(sizes) - jsizes) <= MAP_SIZE_RTOL * jsizes), (np_(sizes), jsizes)
    np.testing.assert_array_equal(np_(states.stats.keyframe_count), np.asarray(jfinal.stats.keyframe_count))
