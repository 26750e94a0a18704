#!/usr/bin/env python3
"""Device memory of the port's pipeline state at a config
(tools/memory_report.py on locus_tpu_torch): the capacity-planning figure
of a deployment (how far map_capacity / scan_capacity can go on one card,
and which part of the state pays for it).

Walks the LocusState and sums its tensors' bytes by top-level field, adds
the transient adders (the live step's upload a scan, a 48-scan packed
replay window), and on the card measures torch.cuda.max_memory_allocated
over a 48-scan production replay (make_tunnel_sequence(azimuth_steps=1800,
step=0.35, seed=0)). From the map field's bytes a slot it states how many
map slots fit in the card's own total_memory, with the rest of the state
beside them, and with the replay's measured peak beside them.

    python tools/memory_report.py [--map-capacity N] [--scan-capacity N] [--device cpu] [--json out]

Runs on the CUDA device unless --device cpu (then the state's bytes only).
Imports neither JAX nor the JAX package.
"""
import argparse
import json

import _torch_tool

REPLAY_SCANS = 48


def state_bytes_by_field(state) -> dict:
    """Bytes of each top-level field of a LocusState (all its tensors)."""
    from locus_tpu_torch.checkpoint import leaves_with_paths

    groups = {}
    for field in state._fields:
        sub = getattr(state, field)
        groups[field] = sum(t.numel() * t.element_size() for _, t in leaves_with_paths(sub))
    return groups


def transients(cfg) -> dict:
    """Bytes of the live step's upload a scan and of a 48-scan packed
    replay window (runner.pack_sequence's tensors)."""
    from locus_tpu_torch.runner import live_aux_len

    per_scan_upload = cfg.raw_scan_capacity * 4 * 4 + 4 * live_aux_len(16, 4)
    # scan_xyz f32, scan_mask bool, stamp f32, IMU (16 stamps, 16 quats),
    # odometry (4 stamps, 4 poses) f32, seq id int32
    window = REPLAY_SCANS * (cfg.raw_scan_capacity * 3 * 4 + cfg.raw_scan_capacity + 4 * (1 + 16 + 64 + 4 + 64 + 1))
    return {"live_per_scan_upload": per_scan_upload, "replay_48_scan_window": window}


def replay_peak_bytes(cfg, dev) -> int:
    """torch.cuda.max_memory_allocated over a 48-scan production replay
    (the packed window included)."""
    import torch

    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    seq = make_tunnel_sequence(num_scans=REPLAY_SCANS, azimuth_steps=1800, step=0.35, seed=0)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    st = pipeline.init_state(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device=dev)
    runner.make_scan_replay(cfg)(st, runner.pack_sequence(seq, cfg, device=dev))
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))


def report(cfg, dev) -> dict:
    """The memory record of `cfg` on `dev` (bytes)."""
    import torch

    from locus_tpu_torch import pipeline

    groups = state_bytes_by_field(pipeline.init_state(cfg, device=dev))
    total = sum(groups.values())
    per_slot = groups["map"] / cfg.mapper.map_capacity
    out = {
        "config": {"map_capacity": cfg.mapper.map_capacity, "scan_capacity": cfg.scan_capacity,
                   "raw_scan_capacity": cfg.raw_scan_capacity},
        "state_bytes_by_field": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "state_total_bytes": total,
        "map_bytes_per_slot": per_slot,
        "transient_bytes": transients(cfg),
        "card_total_memory_bytes": None, "replay_peak_allocated_bytes": None,
        "map_slots_fit_beside_state": None, "map_slots_fit_beside_replay_peak": None,
    }
    _torch_tool.reset_launches()                 # the replay's launches
    if dev.type == "cuda":
        card = torch.cuda.get_device_properties(dev).total_memory
        out["card_total_memory_bytes"] = card
        out["map_slots_fit_beside_state"] = int((card - (total - groups["map"])) / per_slot)
        peak = replay_peak_bytes(cfg, dev)
        out["replay_peak_allocated_bytes"] = peak
        # the replay's peak less its map is what else a slot competes with
        out["map_slots_fit_beside_replay_peak"] = int((card - (peak - groups["map"])) / per_slot)
    out["launches"] = _torch_tool.launch_counts()
    out["note"] = (
        "Per-slot cost is the map field's bytes over map_capacity (the rest of the state does not grow with "
        "the map). map_slots_fit_beside_state: the card's total_memory less the rest of the state, over the "
        "per-slot cost; map_slots_fit_beside_replay_peak: the same less the 48-scan replay's measured peak "
        "allocation (its map excluded). The caching allocator's reserve and the CUDA context are not counted."
    )
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--map-capacity", type=int, default=None)
    ap.add_argument("--scan-capacity", type=int, default=None)
    _torch_tool.add_device_arg(ap)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    dev = _torch_tool.device(args.device)
    cfg = _torch_tool.production_config(map_capacity=args.map_capacity or (1 << 17),
                                        scan_capacity=args.scan_capacity or 4096)
    result = report(cfg, dev) | _torch_tool.device_record(dev)
    print(json.dumps(result, indent=1), flush=True)
    _torch_tool.write_json(args.json, result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
