#!/usr/bin/env python3
"""Pose agreement of the PyTorch port with the JAX package, on the CPU.

`--config` picks the path (chip_smoke.path_config): gicp (the default
configuration), ndt (NDT in both stages), features (LOAM features with
adaptive covariances) or voxel_hash (the voxel-hash map). `--tunnel`
picks the replay:

- small (default): the 12-scan tunnel of tests/test_torch_pipeline.py
  (make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3,
  seed=1) under tests.test_pipeline.small_cfg with the odometry prior;
  features at 256 columns, the sweep's azimuth steps);
- production: chip_smoke.py's protocol, its production config and the
  48-scan make_tunnel_sequence(azimuth_steps=1800, step=0.35, seed=0)
  (`--scans` to cut it);
- eval: the production config on the 48-scan world tunnel of
  tools/eval_suite.py (make_world_sequence("tunnel", azimuth_steps=900),
  the protocol of EVAL_NDT_r05.json), where chip_smoke.py runs NDT.

`--config live|slam` replays chip_smoke.py's live or slam phase (the
2-lap circuit with the pose-graph backend; `--tunnel` does not apply) in
both packages and prints each side's ATE, final error, keyframes and loop
closures.

It replays the tunnel through the JAX package's XLA path and the port's
plain PyTorch path, and prints one JSON line: the per-scan translation
differences, the largest rotation difference, and each side's ATE
(unaligned, against ground truth). With the gicp config on the small
tunnel it adds, as before, JAX's Pallas path (interpret mode) and the
golden sequence through the port.

`--pallas` adds JAX's Pallas path (interpret mode) on any tunnel: JAX's
own XLA-vs-Pallas spread, the measure of its rounding. `--steps` also
steps both packages once from JAX's state before every scan (converted
with `convert.state_from_numpy`) and reports, per scan, how far that one
step puts them apart and at which stage (preprocessed point count,
scan-to-scan transform, scan-to-submap pose, iteration counts), beside
the first scan where the chained replays split by more than 1e-3 m, and,
per scan, both packages' preprocessing of the same raw scan (normals that
part) and the port's scan-to-scan GICP on JAX's preprocessed clouds,
in f32 and with every coordinate in float64, beside JAX's f32 result. A
port that computes the same step stays at f32 noise there however far the
chained replays drift apart.

    JAX_PLATFORMS=cpu python tools/torch_parity.py [--config ndt] [--tunnel production] [--steps] [--pallas]
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


SPLIT_M = 1e-3


def one_steps(seq, cfg, tcfg, tseq, n):
    """Per scan i: JAX's state after scans 0..i-1, converted to the port;
    one step of each on scan i; how far apart the two results lie, stage
    by stage."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from locus_tpu import pipeline as jpl
    from locus_tpu import runner as jrunner
    from locus_tpu_torch import runner as trunner
    from locus_tpu_torch.convert import state_from_numpy

    def t_m(a, b):
        return float(np.linalg.norm(np.asarray(a, np.float64)[:3, 3] - np.asarray(b, np.float64)[:3, 3]))

    rstep = jrunner.make_replay_step(cfg)
    jst = jpl.init_state_from_config(cfg, initial_pose=jnp.asarray(seq.gt_poses[0], jnp.float32))
    jst = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jst)
    rows = []
    for i in range(n):
        args = trunner.scan_inputs(tseq, i, tcfg, "cpu")
        before = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
        stages = preprocess_stage(cfg, tcfg, jst, before, args)
        tst, tout = trunner.replay_step(before, *args, cfg=tcfg)
        jst, jout = rstep(jst, *[jnp.asarray(a.numpy()) for a in args])
        port_on_jax, port64 = stages.pop("_port_gicp_on_jax"), stages.pop("_port_gicp_float64")
        if bool(jout.scan_to_scan_accepted) and i:
            # the port's scan-to-scan GICP on JAX's own preprocessed scan,
            # and both packages' f32 results against its float64 run
            stages["scan_to_scan_on_jax_clouds_m"] = t_m(port_on_jax, jst.odom.incremental)
            stages["scan_to_scan_jax_vs_float64_m"] = t_m(jst.odom.incremental, port64)
            stages["scan_to_scan_port_vs_float64_m"] = t_m(port_on_jax, port64)
        rows.append(stages | {
            "scan": i, "pose_m": t_m(tout.pose.numpy(), jout.pose),
            "scan_to_scan_m": t_m(tst.odom.incremental.numpy(), jst.odom.incremental),
            "scan_to_submap_increment_m": t_m(tst.loc.incremental.numpy(), jst.loc.incremental),
            "num_points": [int(tout.num_points), int(jout.num_points)],
            "odom_iterations": [int(tout.odom_iterations), int(jout.odom_iterations)],
            "loc_iterations": [int(tout.loc_iterations), int(jout.loc_iterations)],
            "map_size": [int(tout.map_size), int(jout.map_size)],
        })
    return rows


def preprocess_stage(cfg, tcfg, jst, tst, args):
    """One scan's preprocessing in both packages from the same raw scan and
    leaf: valid points, coordinates, and normals whose directions part by
    more than 1e-3 (|cos| < 0.999), or that one side leaves zero; and the
    port's scan-to-scan GICP run on JAX's preprocessed scan and reference,
    with the port's prior from the same state."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from locus_tpu import pipeline as jpl
    from locus_tpu.core.cloud import PointCloud as JCloud
    from locus_tpu_torch import fusion, runner as trunner
    from locus_tpu_torch.core.cloud import PointCloud as TCloud
    from locus_tpu_torch.registration.registry import make_registrar

    raw = trunner.raw_cloud(args[0], args[1])
    jscan = jpl.preprocess(JCloud(*(jnp.asarray(a.numpy()) for a in raw)), jst.voxel_leaf, cfg)
    tscan = trunner.pipeline.preprocess(raw, tst.voxel_leaf, tcfg)
    m = np.asarray(jscan.mask)
    na, nb = np.asarray(jscan.normals)[m], tscan.normals.numpy()[m]
    za, zb = ~np.any(na != 0, axis=1), ~np.any(nb != 0, axis=1)
    cos = np.abs(np.sum(na * nb, axis=1))
    fuse = fusion.push_odom_batch(fusion.push_imu_batch(tst.fuse, args[3], args[4]), args[5], args[6])
    sel = fusion.integrate_sensors(fuse, args[2], args[2], tcfg.fusion, prev_stamp=tst.previous_stamp)
    jcloud = TCloud(*(torch.from_numpy(np.array(a)) for a in (jscan.xyz, jscan.normals, jscan.intensity, jscan.mask)))
    register = make_registrar(tcfg.odometry)
    icp = register(jcloud, tst.odom.reference, guess=sel.prior)

    def f64(c):
        return TCloud(c.xyz.double(), c.normals.double(), c.intensity.double(), c.mask)

    # the same registration with every coordinate, normal and product in
    # float64: how far each package's f32 result lies from it
    icp64 = register(f64(jcloud), f64(tst.odom.reference), guess=sel.prior.double())
    return {
        "preprocess_masks_equal": bool(np.array_equal(m, tscan.mask.numpy())),
        "preprocess_xyz_max_m": float(np.abs(np.asarray(jscan.xyz)[m] - tscan.xyz.numpy()[m]).max()),
        "normals_apart": int(np.sum((za != zb) | (~za & ~zb & (cos < 0.999)))), "normals": int(np.sum(~za)),
        "_port_gicp_on_jax": icp.transform.numpy(), "_port_gicp_float64": icp64.transform.numpy(),
    }


def closure_paths(args) -> dict:
    """chip_smoke.py's live or slam phase (`--config live|slam`) in both
    packages on the CPU: the circuit of `--scans` scans (default
    chip_smoke.CIRCUIT_SCANS) at the phase's azimuth steps, the production
    config with the serving velocity gates, the backend's settings; each
    side's ATE, final error, keyframes and loop factors."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke as cs
    from locus_tpu import config as jcfg_mod
    from locus_tpu import pipeline as jpl
    from locus_tpu.backend import PoseGraphBackend as JBackend
    from locus_tpu.core.cloud import PointCloud as JCloud
    from locus_tpu.io.dataset import Sequence
    from locus_tpu.live import LiveSession as JLive
    from locus_tpu.runner import pack_scan, run_sequence as jax_run
    from locus_tpu_torch.convert import config_from_dict

    n = args.scans or cs.CIRCUIT_SCANS
    live = args.config == "live"
    cfg = cs.serving_config(cs.production_config(jcfg_mod))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tseq = cs.circuit_sequence(n, cs.LIVE_AZIMUTH if live else cs.SLAM_AZIMUTH)
    seq = Sequence(**{f.name: getattr(tseq, f.name) for f in dataclasses.fields(Sequence)})
    backend = JBackend(registration=jcfg_mod.RegistrationConfig(**cs.LOOP_REGISTRATION), **cs.LOOP_BACKEND)
    work = Path(os.environ.get("TMPDIR", "/tmp")) / f"torch_parity_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    if live:
        sess = JLive(cfg=cfg, initial_pose=seq.gt_poses[0])
        kf_pre = jax.jit(lambda raw, leaf: jpl.preprocess(raw, leaf, cfg))
        feeds, jposes, keyframes = cs.sensor_feeds(np, tseq), [], 0
        for i in range(n):
            (i0, i1), (o0, o1) = feeds[i]
            for k in range(i0, i1):
                sess.feed_imu(float(seq.imu_stamps[k]), seq.imu_quats[k])
            for k in range(o0, o1):
                sess.feed_odom(float(seq.odom_stamps[k]), seq.odom_poses[k])
            pose, out = sess.process_scan(float(seq.stamps[i]), seq.scans[i], seq.scan_valid[i])
            jposes.append(np.asarray(pose, np.float64))
            if bool(out.keyframe_inserted):
                xyz, mask = pack_scan(seq.scans[i], seq.scan_valid[i], cfg.raw_scan_capacity)
                raw = JCloud(jnp.asarray(xyz), jnp.zeros(xyz.shape, jnp.float32), jnp.zeros(len(mask), jnp.float32),
                             jnp.asarray(mask))
                backend.add_keyframe(float(seq.stamps[i]), pose, cloud=kf_pre(raw, jnp.asarray(0.5)))
                keyframes += 1
                if keyframes % cs.OPTIMIZE_EVERY == 0 and backend.try_close_loops() > 0:
                    backend.optimize()
                    sess.apply_loop_closure(backend.correction_for_latest(), backend.last_corrections)
        jposes = np.stack(jposes)
        rec, port = cs.serve_live(torch, np, tcfg, tseq, torch.device("cpu"), work)
    else:
        jposes, _, _ = jax_run(seq, cfg, backend=backend, backend_optimize_every=cs.OPTIMIZE_EVERY)
        rec, port = cs.run_slam(torch, np, tcfg, tseq, torch.device("cpu"), work)
    jate, jfinal = cs.trajectory_errors(np, jposes, seq.gt_poses)
    return {
        "config": args.config, "scans": n, "port_vs_jax_m": np.linalg.norm(port[:, :3, 3] - jposes[:, :3, 3], axis=1).tolist(),
        "ate_jax_m": jate, "final_error_jax_m": jfinal, "keyframes_jax": len(backend.keyframes),
        "loops_found_jax": backend.loops_found,
        "ate_port_m": rec["ate_m"], "final_error_port_m": rec["final_error_m"], "keyframes_port": rec["keyframes"],
        "loops_found_port": rec["loops_found"], "closures_pushed_back_port": rec["closures_pushed_back"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("gicp", "ndt", "features", "voxel_hash", "live", "slam"), default="gicp")
    ap.add_argument("--tunnel", choices=("small", "production", "eval"), default="small")
    ap.add_argument("--scans", type=int, default=None, help="replay only the first N scans")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--pallas", action="store_true", help="add JAX's Pallas path (interpret mode)")
    ap.add_argument("--steps", action="store_true", help="one step of each from JAX's state before every scan")
    args = ap.parse_args()

    import numpy as np
    import torch

    from chip_smoke import SCANS, path_config, production_config
    from locus_tpu import config as jcfg_mod
    from locus_tpu.config import FusionConfig
    from locus_tpu.io.dataset import Sequence, make_tunnel_sequence, make_world_sequence
    from locus_tpu.metrics import ate_rmse
    from locus_tpu.ops.dispatch import force_pallas
    from locus_tpu.runner import run_sequence as jax_run
    from locus_tpu_torch.convert import config_from_dict
    from locus_tpu_torch.io.dataset import Sequence as TSequence
    from locus_tpu_torch.runner import run_sequence as port_run
    from tests.test_pipeline import small_cfg

    torch.set_num_threads(args.threads)
    if args.config in ("live", "slam"):
        print(json.dumps(closure_paths(args)))
        return 0

    def port_seq(seq):
        return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})

    if args.tunnel == "small":
        cfg = path_config(small_cfg(fusion=FusionConfig(data_integration_mode=3)), args.config)
        if args.config == "features":
            cfg = cfg.replace(filtering=dataclasses.replace(cfg.filtering, feature_width=256))
        seq = make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3, seed=1)
    elif args.tunnel == "production":
        cfg = path_config(production_config(jcfg_mod), args.config)
        seq = make_tunnel_sequence(num_scans=SCANS, azimuth_steps=1800, step=0.35, seed=0)
    else:
        cfg = path_config(production_config(jcfg_mod), args.config)
        if args.config == "features":
            cfg = cfg.replace(filtering=dataclasses.replace(cfg.filtering, feature_width=900))
        seq = make_world_sequence("tunnel", num_scans=SCANS, azimuth_steps=900)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    xla, _, _ = jax_run(seq, cfg, max_scans=args.scans)
    port, _, _ = port_run(port_seq(seq), tcfg, max_scans=args.scans, device="cpu")
    n = xla.shape[0]

    def diff(a, b):
        return np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).tolist()

    def ate(p):
        return ate_rmse(p[:, :3, 3], seq.gt_poses[:n, :3, 3], align=False)

    out = {
        "config": args.config, "tunnel": args.tunnel, "scans": n,
        "port_vs_jax_xla_m": diff(port, xla),
        "port_vs_jax_xla_max_rotation_entry": float(np.abs(port[:, :3, :3] - xla[:, :3, :3]).max()),
        "ate_jax_xla_m": ate(xla), "ate_port_m": ate(port),
    }
    split = [i for i, d in enumerate(out["port_vs_jax_xla_m"]) if d > SPLIT_M]
    out["first_scan_split_over_1e-3_m"] = split[0] if split else None
    if args.steps:
        out["one_step_from_jax_state"] = one_steps(seq, cfg, tcfg, port_seq(seq), n)
    if args.pallas and not (args.config == "gicp" and args.tunnel == "small"):
        with force_pallas():
            pallas, _, _ = jax_run(seq, cfg, max_scans=args.scans)
        out["jax_xla_vs_jax_pallas_m"] = diff(xla, pallas)
        out["port_vs_jax_pallas_m"] = diff(port, pallas)
    if args.config == "gicp" and args.tunnel == "small":
        with force_pallas():
            pallas, _, _ = jax_run(seq, cfg, max_scans=args.scans)
        golden_seq = Sequence.load(str(ROOT / "tests" / "data" / "golden_seq.npz"))
        golden = np.load(ROOT / "tests" / "data" / "golden_poses.npy")
        gport, _, _ = port_run(port_seq(golden_seq), tcfg, device="cpu")
        out |= {
            "tunnel_jax_xla_vs_jax_pallas_m": diff(xla, pallas),
            "tunnel_port_vs_jax_pallas_m": diff(port, pallas),
            "golden_port_max_m": float(np.linalg.norm(gport[:, :3, 3] - golden[:, :3, 3], axis=1).max()),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
