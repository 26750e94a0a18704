"""The port's online SLAM loop: `runner.run_sequence(backend=)` with the
pose-graph backend, loop closures pushed back by `push_back_closure`
(set_integrated_estimate, the map's reanchor, the keyframe anchor),
against the JAX package's: the cases of tests/test_slam_integration.py.

Tolerance against JAX: the scans before the loop can close within 1e-2 m
and 1e-2 rad (tests/test_torch_pipeline.py's replay tolerance) and equal
keyframe decisions there; after closures each side is held to the JAX
test's own bounds. `test_full_slam_loop_with_backend` is marked slow in
the JAX file (Tier-1 deselects it) and optimises on an 8-device mesh
(ROADMAP A16): it has no counterpart. Its endurance leg
(test_slam_integration.py:238) is `test_endurance_mechanisms_scaled`, and
`test_slam_replay_scaled` runs chip_smoke.py's slam phase at CI shapes on
the CPU.
"""
import dataclasses
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from locus_tpu import runner as jrunner
from locus_tpu.backend import PoseGraphBackend as JBackend
from locus_tpu.config import FilterConfig, FusionConfig, LocusConfig, MapperConfig
from locus_tpu.io.dataset import make_circuit_sequence
from locus_tpu_torch import localization, pipeline, runner
from locus_tpu_torch.backend import PoseGraphBackend
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.io.dataset import Sequence as TSequence
from locus_tpu_torch.mapping import keyframe_map
from tests.test_slam_integration import loop_sequence
from tests.torch_helpers import pose_diff

POSE_TOL_M = POSE_TOL_RAD = 1e-2
BEFORE_CLOSURES = 40     # the 96-scan loop cannot close before this scan


def _tseq(seq):
    return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})


def _cfg(**mapper):
    return LocusConfig(
        scan_capacity=1024, raw_scan_capacity=8192, points_to_process_in_callback=800,
        filtering=FilterConfig(normals_k=12),
        mapper=MapperConfig(**{"map_capacity": 16384, "keyframe_capacity": 1024, "map_voxel_leaf": 0.1, **mapper}),
        fusion=FusionConfig(data_integration_mode=0),
    )


def test_online_backend_in_runner_matches_jax():
    """Loop closures found and pushed back during the replay."""
    seq = loop_sequence(num_scans=96)
    jcfg = _cfg()
    kw = dict(loop_distance=2.5, min_index_gap=8, loop_fitness_max=0.12)
    jb, tb = JBackend(**kw), PoseGraphBackend(device="cpu", **kw)
    jp, jo, _ = jrunner.run_sequence(seq, jcfg, backend=jb, backend_optimize_every=4)
    tp, to, _ = runner.run_sequence(_tseq(seq), config_from_dict(dataclasses.asdict(jcfg)), backend=tb,
                                    backend_optimize_every=4, device="cpu")
    for i in range(BEFORE_CLOSURES):
        dt, dr = pose_diff(tp[i], jp[i])
        assert dt < POSE_TOL_M and dr < POSE_TOL_RAD, (i, dt, dr)
    assert [o["keyframe_inserted"] for o in to[:BEFORE_CLOSURES]] == [o["keyframe_inserted"] for o in jo[:BEFORE_CLOSURES]]
    for backend, poses in ((tb, tp), (jb, jp)):
        assert len(backend.keyframes) >= 15 and backend.loops_found >= 1
        assert np.linalg.norm(poses[-1][:3, 3] - seq.gt_poses[-1][:3, 3]) < 0.5


def _prefix(cfg, seq, n):
    state = pipeline.init_state(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device="cpu")
    return _suffix(cfg, seq, state, 0, n)


def _suffix(cfg, seq, state, lo, hi):
    out = None
    for i in range(lo, hi):
        state, out = runner.replay_step(state, *runner.scan_inputs(seq, i, cfg, "cpu"), cfg=cfg)
    return state, out


def test_closure_correction_keeps_map_consistent():
    """After a 0.7 m correction the re-anchored map keeps scan-to-submap
    consistent with the corrected pose: the next 12 scans are the
    uncorrected continuation moved by the correction (within 1e-2 m);
    without the reanchor the stale map drags the estimate away by more
    than 3x that bound (tests/test_slam_integration.py:174's ratio).

    The JAX test holds the continuation within 0.15 m of the shifted
    ground truth. On this 36-scan loop (0.87 m and 10 degrees a scan,
    pure lidar odometry) scan 1 is chaotic: scans moved by 1e-5 m of
    noise, 400x below the sensor's, move JAX's own scan-1 pose by up to
    0.19 m (tools/torch_chaos_probe.py), and the port lands 0.21 m from
    the ground truth on the unperturbed scans. So the port is held to its
    own uncorrected continuation, which isolates what the push-back must
    do: move pose and map together."""
    seq = _tseq(loop_sequence(num_scans=36))
    cfg = config_from_dict(dataclasses.asdict(_cfg()))
    n_pre, n_post = 24, 36
    state0, out0 = _prefix(cfg, seq, n_pre)
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [0.6, -0.3, 0.2]
    T = torch.as_tensor(shift)
    corrected = T @ out0.pose
    K = int(state0.stats.keyframe_count)
    assert K >= 2
    base = state0._replace(
        loc=localization.set_integrated_estimate(state0.loc, corrected),
        odom=state0.odom._replace(integrated=corrected),
        last_keyframe_pose=T @ state0.last_keyframe_pose,
    )
    anchored = base._replace(map=keyframe_map.reanchor(state0.map, T.expand(K, 4, 4), cfg.mapper))
    _, plain = _suffix(cfg, seq, state0, n_pre, n_post)
    target = shift.astype(np.float64) @ plain.pose.numpy().astype(np.float64)
    _, good = _suffix(cfg, seq, anchored, n_pre, n_post)
    err_good = np.linalg.norm(good.pose.numpy()[:3, 3] - target[:3, 3])
    assert bool(good.scan_to_map_accepted) and err_good < POSE_TOL_M, err_good
    _, bad = _suffix(cfg, seq, base, n_pre, n_post)
    err_bad = np.linalg.norm(bad.pose.numpy()[:3, 3] - target[:3, 3])
    assert err_bad > 3.0 * max(err_good, 0.05), (err_good, err_bad)


def test_endurance_mechanisms_scaled():
    """A 2-lap circuit through an over-subscribed ring: window restarts,
    MSW refreshes, lap-2 closures with reanchor push-back, a bounded
    trajectory (tests/test_slam_integration.py:238 on the port)."""
    seq = _tseq(make_circuit_sequence(num_scans=60, step=0.5, laps=2, azimuth_steps=360, half_width=2.0,
                                      corner_radius=2.0, seed=3))
    cfg = config_from_dict(dataclasses.asdict(_cfg(
        map_capacity=2048, map_voxel_leaf=0.15, translation_threshold_msw=4.0,
        translational_velocity_threshold=1e3, rotational_velocity_threshold=1e3,
    ).replace(fusion=FusionConfig())))
    backend = PoseGraphBackend(loop_distance=2.0, min_index_gap=8, loop_fitness_max=0.15, device="cpu")
    state = pipeline.init_state_from_config(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32),
                                            device="cpu")
    wraps = msw = kf = since = reanchors = prev_ptr = 0
    poses = []
    for i in range(len(seq)):
        args = runner.scan_inputs(seq, i, cfg, "cpu")
        state, out = runner.replay_step(state, *args, cfg=cfg)
        pose = out.pose.numpy()
        poses.append(pose)
        assert np.isfinite(pose).all() and int(out.map_size) <= cfg.mapper.map_capacity
        msw += int(bool(out.msw_refreshed))
        ptr = int(state.map.write_ptr)
        wraps += ptr < prev_ptr
        prev_ptr = ptr
        if bool(out.keyframe_inserted):
            backend.add_keyframe(float(seq.stamps[i]), pose, cloud=runner.verification_cloud(args[0], args[1], cfg))
            kf += 1
            since += 1
            if since >= 4:
                since = 0
                if backend.try_close_loops() > 0:
                    backend.optimize()
                    state = runner.push_back_closure(state, backend.correction_for_latest(),
                                                     backend.corrections_padded(bucket=8), cfg)
                    reanchors += 1
    assert wraps >= 2 and msw >= 2 and kf >= 15, (wraps, msw, kf)
    assert backend.loops_found >= 1 and reanchors >= 1
    assert np.linalg.norm(np.stack(poses)[-1, :3, 3] - seq.gt_poses[-1, :3, 3]) < 2.5


def test_slam_replay_scaled(tmp_path):
    """chip_smoke.py's slam phase at CI shapes on the CPU: closures found
    and pushed back, the checkpointed replay resumed bit for bit."""
    cfg = config_from_dict(dataclasses.asdict(_cfg(map_capacity=1 << 13, map_voxel_leaf=0.15).replace(
        fusion=FusionConfig())))
    circuit = chip_smoke.circuit_sequence(60, 360, workers=2)
    rec, poses = chip_smoke.run_slam(torch, np, chip_smoke.serving_config(cfg), circuit, torch.device("cpu"),
                                     Path(tmp_path), resume_at=20)
    assert np.isfinite(poses).all()
    assert rec["loops_found"] >= 1 and rec["closures_pushed_back"] >= 1 and rec["keyframes"] >= 15
    assert rec["resume_bit_equal"] and rec["ab_max_translation_m"] == 0.0
    assert rec["ate_m"] < 0.1 and rec["final_error_m"] < 0.1, rec
