#!/usr/bin/env python3
"""Scaling of the port's batched replay over ranks (the counterpart of
tools/scaling_bench.py): runner.make_batched_replay(mesh=) on a (ranks, 1)
mesh, --seqs-per-rank robots a rank (robot b on make_tunnel_sequence(
num_scans, azimuth, step=0.35, seed=b)), at --ranks 1 2 4, each rank count
a launch of tools/torch_dist_smoke.py --mode dp through
parallel.distributed.spawn_ranks. Reports each rank count's robot-scans/s
(each rank's robots times its ticks/s over the ticks after the first,
summed over the ranks) and its efficiency against 1 rank
(rate(n) / (n * rate(1))). --repeats R launches every rank count R times,
the counts interleaved (1, 2, 4, 1, 2, 4, ...): each rate is the median of
its R launches, each efficiency the median of the R launches' own, and
each has its spread ((max - min) / median) beside it, so that a reader can
tell a property of the program from the host's pace between launches.

Every robot of every rank count must give the poses of the 1-rank run:
this process first replays all the robots of the largest count in one
batch on one rank (no mesh), and every rank holds its own robots to those
poses, bit for bit.

On one card the ranks share it and the host's cores, their collectives
through gloo: the numbers measure the SPMD program, not scaling across
cards. --backend nccl takes one card a rank and needs a host with as many
cards as ranks.

    python tools/torch_scaling_bench.py [--ranks 1 2 4] [--scans 6] [--repeats 1]
        [--seqs-per-rank 1] [--production] [--backend gloo] [--device cpu] [--json out]

--production: 4096-point scans and a 65536-slot map, 1800 azimuth steps
(tools/scaling_bench.py's production shapes); otherwise its small shapes
(512-point scans, a 4096-slot map, 128 azimuth steps). Runs on the CUDA
device unless --device cpu. Imports neither JAX nor the JAX package.
"""
import argparse
import json
import tempfile
from pathlib import Path

import _torch_tool
import numpy as np

STEP_M = 0.35
PRODUCTION_MAP = 1 << 16


def shapes(production: bool, azimuth=None) -> tuple:
    """(profile of tools/torch_dist_smoke.py, map capacity or None, azimuth)."""
    if production:
        return "production", PRODUCTION_MAP, azimuth or 1800
    return "scaling", None, azimuth or 128


def single_rank_poses(profile: str, map_capacity, robots: int, scans: int, azimuth: int, dev) -> np.ndarray:
    """(T, robots, 4, 4) poses of all the robots in one batched replay on
    this process (one rank, no mesh)."""
    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    cfg = _torch_tool.rank_config(profile, map_capacity, mode="dp")
    seqs = [make_tunnel_sequence(num_scans=scans, azimuth_steps=azimuth, step=STEP_M, seed=b) for b in range(robots)]
    packed = runner.stack_packed([runner.pack_sequence(s, cfg, device=dev) for s in seqs])
    states = pipeline.init_states(cfg, np.stack([s.gt_poses[0] for s in seqs]), device=dev)
    _, (poses, _, _) = runner.make_batched_replay(cfg)(states, packed)
    return poses.cpu().numpy()


def spread(values) -> float:
    """(max - min) / median of `values`."""
    return float((max(values) - min(values)) / np.median(values))


def scaling(rank_counts, scans: int, seqs_per_rank: int, production: bool, dev, backend: str = "gloo",
            azimuth=None, workdir=None, timeout_s: float = 900.0, repeats: int = 1) -> dict:
    """Every rank count's rate, efficiency (each the median of `repeats`
    launches, with its spread) and pose check."""
    profile, map_capacity, azimuth = shapes(production, azimuth)
    most = max(rank_counts) * seqs_per_rank
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(workdir or tmp)
        work.mkdir(parents=True, exist_ok=True)
        ref = work / "single_rank_poses.npz"
        np.savez(ref, poses=single_rank_poses(profile, map_capacity, most, scans, azimuth, dev))
        runs = {n: [] for n in rank_counts}
        for rep in range(repeats):
            for n in rank_counts:
                argv = ["--mode", "dp", "--map-parallel", 1, "--device", dev.type, "--backend", backend,
                        "--profile", profile, "--robots", n * seqs_per_rank, "--scans", scans,
                        "--azimuth", azimuth, "--step", STEP_M, "--seed", 0, "--ref", ref,
                        "--window", max(scans - 1, 1)]
                if map_capacity:
                    argv += ["--map-capacity", map_capacity]
                run = _torch_tool.launch_ranks(argv, n, work / f"ranks{n}_{rep}", timeout_s)
                ranks = run["ranks"]
                runs[n].append({
                    "rate": sum(len(r["owned_rows"]) * r["scans_per_s_last"] for r in ranks),
                    "ticks_per_s_per_rank": [r["scans_per_s_last"] for r in ranks],
                    "wall_s_per_rank": [r["wall_s"] for r in ranks],
                    "bit_equal": run["bit_equal"], "max_pose_err": run["max_pose_err"],
                    "launches_per_rank": [r["launches"] for r in ranks],
                })
    base = min(rank_counts)
    results = {}
    for n, rr in runs.items():
        rates = [r["rate"] for r in rr]
        # each launch against the 1-rank launch of its own repeat
        effs = [r["rate"] * base / (n * b["rate"]) for r, b in zip(rr, runs[base])]
        results[n] = {
            "robots": n * seqs_per_rank,
            "seq_scans_per_sec": float(np.median(rates)), "seq_scans_per_sec_runs": rates,
            "seq_scans_per_sec_spread": spread(rates),
            "efficiency": float(np.median(effs)), "efficiency_runs": effs, "efficiency_spread": spread(effs),
            "ticks_per_s_per_rank": [r["ticks_per_s_per_rank"] for r in rr],
            "wall_s_per_rank": [r["wall_s_per_rank"] for r in rr],
            "poses_equal_single_rank": all(r["bit_equal"] for r in rr),
            "max_pose_err": max(r["max_pose_err"] for r in rr),
            "launches_per_rank": rr[-1]["launches_per_rank"],
        }
    return {
        "results": {str(n): r for n, r in results.items()},
        "poses_equal_single_rank": all(r["poses_equal_single_rank"] for r in results.values()),
        "profile": profile, "map_capacity": map_capacity, "scans": scans, "azimuth": azimuth,
        "seqs_per_rank": seqs_per_rank, "backend": backend, "repeats": repeats,
        "rate_window": f"the {max(scans - 1, 1)} ticks after the first",
        "note": ("the ranks are processes on one host" + (" sharing one card" if dev.type == "cuda" else "")
                 + f", their collectives through {backend}: the numbers measure the SPMD program, "
                 "not scaling across cards"),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", nargs="*", type=int, default=[1, 2, 4])
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=1,
                    help="launches of every rank count, interleaved; each rate is their median")
    ap.add_argument("--seqs-per-rank", type=int, default=1)
    ap.add_argument("--production", action="store_true",
                    help="4096-point scans, a 65536-slot map, 1800 azimuth steps")
    ap.add_argument("--azimuth", type=int, default=None)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    _torch_tool.add_device_arg(ap)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    dev = _torch_tool.device(args.device)
    result = scaling(args.ranks, args.scans, args.seqs_per_rank, args.production, dev, args.backend,
                     args.azimuth, repeats=args.repeats) | _torch_tool.device_record(dev)
    print(json.dumps(result), flush=True)
    _torch_tool.write_json(args.json, result)
    return 0 if result["poses_equal_single_rank"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
