#!/usr/bin/env python3
"""Communication budget of the port's sharded replay (the counterpart of
tools/collective_budget.py, which counts the collectives in XLA's HLO).

In the port the sharded replay (runner.make_scan_replay(mesh=), the map
split over the mesh's "map" axis) has one collective,
parallel/distributed.gather_ranked, called twice a scan: the map ANN's
winners (`sharded_map.merge_winners`: scan_capacity x 10 f32, the score,
the distance, the point, its normal, intensity and validity) and the map
size (`keyframe_map.map_size`: one int32). The bytes a scan are computed
from those shapes, then checked against a counting wrapper around every
call of `gather_ranked` over a real run of --ranks ranks
(tools/torch_dist_smoke.py --count-collectives), and the ms a scan spent
inside `gather_ranked` (staging through the host included with gloo) are
read from the spans that tools/torch_dist_smoke.py --trace-collectives
times. No link bandwidth is modelled.

    python tools/torch_collective_budget.py [--ranks 2] [--profile production] [--scans 24]
        [--azimuth 1800] [--backend gloo] [--device cpu] [--json out]

On one card the ranks share it, their gathers through gloo; the bytes do
not depend on that. Runs on the CUDA device unless --device cpu. Imports
neither JAX nor the JAX package.
"""
import argparse
import json
import tempfile
from pathlib import Path

import _torch_tool

ANN_COLUMNS = 10   # merge_winners: the score and 9 columns of the winning point


def computed_collectives(cfg, shards: int) -> dict:
    """The gathers a scan of the sharded replay from their shapes: per
    gather the tensor one rank sends and the gathered bytes it receives
    (its own part included). A map of one shard gathers nothing (the
    replay skips the collectives on a map axis of 1)."""
    ops = {
        "ann_winners": {"shape": [cfg.scan_capacity, ANN_COLUMNS], "dtype": "float32",
                        "bytes_each": cfg.scan_capacity * ANN_COLUMNS * 4},
        "map_size": {"shape": [], "dtype": "int32", "bytes_each": 4},
    } if shards > 1 else {}
    sent = sum(op["bytes_each"] for op in ops.values())
    return {"gathers_per_scan": len(ops), "ops": ops, "sent_bytes_per_scan": sent,
            "per_scan_collective_bytes": sent * shards}


def budget(profile: str, ranks: int, scans: int, azimuth: int, device: str, backend: str, workdir,
           timeout_s: float = 900.0) -> dict:
    """The computed bytes a scan beside the counted ones and the traced ms
    of a run of `ranks` ranks."""
    cfg = _torch_tool.rank_config(profile)
    computed = computed_collectives(cfg, ranks)
    run = _torch_tool.launch_ranks(
        ["--mode", "pipeline", "--device", device, "--backend", backend, "--profile", profile, "--scans", scans,
         "--azimuth", azimuth, "--seed", 0, "--count-collectives", "--trace-collectives"],
        ranks, Path(workdir) / "ranks", timeout_s)
    counted = [r["counted_collectives"] for r in run["ranks"]]
    match = all(c["calls_per_step"] == computed["gathers_per_scan"]
                and c["sent_bytes_per_step"] == computed["sent_bytes_per_scan"]
                and c["gathered_bytes_per_step"] == computed["per_scan_collective_bytes"] for c in counted)
    return {
        "ranks": ranks, "map_shards": ranks, "backend": backend, "profile": profile, "scans": scans,
        "scan_capacity": cfg.scan_capacity, "map_capacity": cfg.mapper.map_capacity,
        **computed,
        "counted": counted, "computed_equals_counted": match,
        "collective_ms_per_scan": [r["collective_ms_per_step"] for r in run["ranks"]],
        "collectives_per_scan_traced": [r["collectives_per_step"] for r in run["ranks"]],
        "ms_p50_per_scan_traced": [r["ms_p50_last"] for r in run["ranks"]],
        "sharded_equals_single": run["bit_equal"],
        "launches_per_rank": [r["launches"] for r in run["ranks"]],
        "note": ("bytes a scan a rank: sent = the tensors it contributes, per_scan_collective_bytes = the "
                 "gathered tensors it receives (tools/collective_budget.py counts the gathered output); "
                 "collective_ms_per_scan: inside gather_ranked under the profiler, staging included"),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2, help="map shards, one rank each")
    ap.add_argument("--profile", default="production", choices=("tiny", "ci", "scaling", "production"))
    ap.add_argument("--scans", type=int, default=24)
    ap.add_argument("--azimuth", type=int, default=1800)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    _torch_tool.add_device_arg(ap)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    dev = _torch_tool.device(args.device)
    with tempfile.TemporaryDirectory() as work:
        result = budget(args.profile, args.ranks, args.scans, args.azimuth, dev.type, args.backend, work)
    result |= _torch_tool.device_record(dev)
    print(json.dumps(result), flush=True)
    _torch_tool.write_json(args.json, result)
    return 0 if result["computed_equals_counted"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
