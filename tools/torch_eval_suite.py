#!/usr/bin/env python3
"""Multi-world replay regression of the port (tools/eval_suite.py on
locus_tpu_torch): replays the tunnel, urban, cave and loop worlds of
io.dataset.make_world_sequence (60 scans of 900 azimuth steps, 0.35 m a
scan) and reports ATE, RPE and, on the loop world, the loop closures of the
online pose-graph backend (PoseGraphBackend(loop_distance=2.5,
min_index_gap=8, loop_fitness_max=0.12), tools/eval_suite.py:93-118).

Modes, in both registration stages: GICP (default), --method ndt (with
--ndt-resolution / --ndt-neighborhood), and --features (the LOAM features
with adaptive covariances). ATE does not depend on the platform, so each
world's row carries the JAX package's row for the same mode beside it
(EVAL_r05.json, EVAL_NDT_r05.json, EVAL_FEATURES_r05.json at the root of
the repository) and the port's gap to it. The fifth world of
tools/eval_suite.py, the reference's garage PCD, lies outside the
repository and is left out.

    python tools/torch_eval_suite.py [--scans 60] [--azimuth 900] [--method gicp|ndt]
        [--ndt-resolution R] [--ndt-neighborhood direct7] [--features] [--device cpu] [--json out]

Runs on the CUDA device unless --device cpu. Imports neither JAX nor the
JAX package.
"""
import argparse
import dataclasses
import json
from pathlib import Path

import _torch_tool
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WORLDS = ("tunnel", "urban", "cave", "loop")
LOOP_BACKEND = {"loop_distance": 2.5, "min_index_gap": 8, "loop_fitness_max": 0.12}
STEP_M = 0.35   # make_world_sequence's step


def eval_config(method="gicp", ndt_resolution=None, ndt_neighborhood=None, features=False, azimuth=900, base=None):
    """tools/eval_suite.py's config (4096-point scans, 32768-point raw
    sweeps, a 131072-slot map) or `base`, in the given mode."""
    from locus_tpu_torch.config import LocusConfig, MapperConfig

    rep = dataclasses.replace
    cfg = base or LocusConfig(
        scan_capacity=4096, raw_scan_capacity=32768, points_to_process_in_callback=3000,
        mapper=MapperConfig(map_capacity=1 << 17, keyframe_capacity=4096),
    )

    def both_stages(c, **kw):
        return c.replace(odometry=rep(c.odometry, **kw),
                         localization=rep(c.localization, registration=rep(c.localization.registration, **kw)))

    if method != "gicp":
        over = {k: v for k, v in (("ndt_resolution", ndt_resolution), ("ndt_neighborhood", ndt_neighborhood))
                if v is not None}
        cfg = both_stages(cfg, registration_method=method, **over)
    if features:
        cfg = both_stages(cfg.replace(filtering=rep(cfg.filtering, extract_features=True, feature_width=azimuth)),
                          covariance_mode="adaptive")
    return cfg


def replay_world(cfg, seq, world: str, dev):
    """(poses, loop closures or None) of one world's replay: the loop world
    with the pose-graph backend."""
    from locus_tpu_torch import runner
    from locus_tpu_torch.backend import PoseGraphBackend

    backend = PoseGraphBackend(device=dev, **LOOP_BACKEND) if world == "loop" else None
    poses, _, _ = runner.run_sequence(seq, cfg, collect_outputs=False, backend=backend, device=dev)
    return poses, None if backend is None else backend.loops_found


def evaluate(cfg, num_scans: int, azimuth: int, dev, worlds=WORLDS) -> dict:
    """{world: {ate_m, rpe_t_m, rpe_r_deg, distance_m[, loop_closures]}}."""
    from locus_tpu_torch.io.dataset import make_world_sequence
    from locus_tpu_torch.metrics import ate_rmse, rpe

    results = {}
    for world in worlds:
        seq = make_world_sequence(world, num_scans=num_scans, azimuth_steps=azimuth)
        poses, closures = replay_world(cfg, seq, world, dev)
        gt = seq.gt_poses[: poses.shape[0]]
        t_rpe, r_rpe = rpe(poses, gt)
        results[world] = {
            "ate_m": ate_rmse(poses[:, :3, 3], gt[:, :3, 3], align=False),
            "rpe_t_m": t_rpe, "rpe_r_deg": float(np.degrees(r_rpe)), "distance_m": num_scans * STEP_M,
        }
        if closures is not None:
            results[world]["loop_closures"] = closures
    return results


def reference_rows(method="gicp", ndt_resolution=None, ndt_neighborhood=None, features=False) -> tuple:
    """(file, {world: the JAX package's row}) of the mode, or (None, {})
    where no r05 file holds it."""
    if features:
        name = "EVAL_FEATURES_r05.json"
        rows = json.loads((ROOT / name).read_text())
        return name, {w: rows[w] for w in WORLDS if w in rows}
    if method == "ndt":
        name = "EVAL_NDT_r05.json"
        key = f"ndt_{ndt_neighborhood or 'direct7'}_{ndt_resolution or 1.0}m"
        worlds = json.loads((ROOT / name).read_text())["worlds"]
        rows = {w: worlds[w][key] for w in WORLDS if key in worlds.get(w, {})}
        return (name + f":{key}", rows) if rows else (None, {})
    name = "EVAL_r05.json"
    rows = json.loads((ROOT / name).read_text())
    return name, {w: rows[w] for w in WORLDS if w in rows}


def with_reference(results: dict, source, rows: dict) -> dict:
    """`results` with each world's JAX row and the port's gap to it."""
    out = {"worlds": results, "reference": source}
    for world, r in results.items():
        if world in rows:
            ref = rows[world]
            r["jax_ate_m"] = ref["ate_m"]
            r["ate_gap_to_jax_m"] = r["ate_m"] - ref["ate_m"]
            if "loop_closures" in ref:
                r["jax_loop_closures"] = ref["loop_closures"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=60)
    ap.add_argument("--azimuth", type=int, default=900)
    ap.add_argument("--method", default="gicp", choices=["gicp", "ndt"])
    ap.add_argument("--ndt-resolution", type=float, default=None)
    ap.add_argument("--ndt-neighborhood", default=None, choices=["direct1", "direct7", "direct26", "kdtree"])
    ap.add_argument("--features", action="store_true",
                    help="the LOAM feature path with adaptive covariances in both stages")
    _torch_tool.add_device_arg(ap)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    dev = _torch_tool.device(args.device)
    mode = dict(method=args.method, ndt_resolution=args.ndt_resolution, ndt_neighborhood=args.ndt_neighborhood,
                features=args.features)
    cfg = eval_config(**mode, azimuth=args.azimuth)
    _torch_tool.reset_launches()
    results = evaluate(cfg, args.scans, args.azimuth, dev)
    launches = _torch_tool.launch_counts()
    out = with_reference(results, *reference_rows(**mode)) | {
        "mode": mode, "scans": args.scans, "azimuth": args.azimuth} | _torch_tool.device_record(dev)
    out["launches"] = launches
    print(json.dumps(out), flush=True)
    _torch_tool.write_json(args.json, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
