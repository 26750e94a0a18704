#!/usr/bin/env python3
"""Smoke test of locus_tpu_torch on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs a CUDA
device and the repository's `locus_tpu_torch` package beside this file,
and fails (non-zero exit, no result line) without either. It imports
nothing of JAX or of `locus_tpu`.

Phases, each printing one JSON line:
 1. device     card name and the nvidia-smi power limit
 2. build      nvcc of every kernel source, all at once
 3. reference  the first 8 scans of the production tunnel replay with the
               kernels' plain PyTorch versions (`no_kernels()`), on the card
 4. kernels    each kernel at the shapes the main path gives it (inputs
               from the reference run's state), against its plain version
               on the same inputs, timed with CUDA events beside the plain
               version, a one-call PyTorch yardstick where one exists, and
               the bound from this run's visited pairs
 5. pipeline   the 48-scan production replay through runner.run_sequence
               with launch counts reset just before and read just after;
               scans/s over the last 32 scans and ATE against ground truth
 6. ab         the pipeline's first 8 poses against the reference run's
Then the `kernels` summary line, the nvidia-smi line, and the final
`{"ok": true, ...}` line. The full record also goes to
chiprun_out/chip_smoke.json.
"""
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM bandwidth, the roofline of both kernels.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

SCANS, REF_SCANS, RATE_WINDOW = 48, 8, 32
ATE_LIMIT_M = 0.05
AB_LIMIT_M = 1e-3
D2_TOL = 1e-5       # kernel vs plain, squared distance of the winner [m^2]
MOMENT_RTOL = 1e-6  # kernel vs plain, raw moment sums (float64 sums: exact)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def production_config(cfg_mod):
    """The production config of bench.py:36-47."""
    return cfg_mod.LocusConfig(
        scan_capacity=4096,
        raw_scan_capacity=32768,
        points_to_process_in_callback=3000,
        filtering=cfg_mod.FilterConfig(normals_k=20),
        mapper=cfg_mod.MapperConfig(map_capacity=1 << 17, keyframe_capacity=4096, map_voxel_leaf=0.15),
    )


def device_time_ms(torch, fn, reps=20, warmup=3):
    """Median device time of fn() in ms: CUDA events around each call,
    queued behind a sleep kernel so host enqueue time is not measured."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(ops, nbytes):
    t_ops = ops / PEAK_FP32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def check_nn(torch, tnn, name, query, t_aug, target, c_min, c_max, radius, bt, library):
    """Kernel B2 against its plain version on one main-path call."""
    tmin, tmax = tnn.tile_boxes(query)
    cnt, ids = tnn.visit_lists(tmin, tmax, c_min, c_max, radius * radius)
    q = tnn.pack_query(query)
    before = dict(tnn.launches)
    ks, ki = tnn.nn_visits(cnt, ids, q, t_aug, bt)
    torch.cuda.synchronize()
    ps, pi = tnn.nn_visits_plain(cnt, ids, q, t_aug, bt)
    tnn.launches.update(before)  # comparison launches are not main-path launches
    n, m = query.shape[0], target.shape[0]
    valid = torch.all(query.abs() < 1e7, dim=1)
    ki64 = ki[:n].long().clamp(0, m - 1)
    pi64 = pi[:n].long().clamp(0, m - 1)
    kd2 = ((query - target[ki64]) ** 2).sum(1)
    pd2 = ((query - target[pi64]) ** 2).sum(1)
    inside = valid & (pd2 <= radius * radius)
    err = float((kd2 - pd2)[inside].abs().max()) if bool(inside.any()) else 0.0
    idx_diff = int((inside & (ki64 != pi64)).sum())
    ok = err <= D2_TOL
    visited = int(cnt.sum()) * tnn.BQ * bt
    ms = device_time_ms(torch, lambda: tnn.nn_visits(cnt, ids, q, t_aug, bt))
    tnn.launches.update(before)
    plain_ms = device_time_ms(torch, lambda: tnn.nn_visits_plain(cnt, ids, q, t_aug, bt), reps=5)
    lib_ms = device_time_ms(torch, library, reps=5) if library is not None else None
    nbytes = q.numel() * 4 + t_aug.numel() * 4 + cnt.numel() * 4 + ids.numel() * 4 + q.shape[0] * 8
    b, by = bound_ms(visited * 7, nbytes)
    return ok, {
        "name": name, "route": "cuda", "source": "locus_tpu_torch/csrc/nn.cu",
        "replaces": "locus_tpu/ops/pallas/nn.py:208",
        "queries": n, "targets": m, "bt": bt, "radius": float(radius),
        "visited_pairs": visited, "max_abs_err": err, "index_mismatches_within_tol": idx_diff,
        "tolerance": f"winner d2 within {D2_TOL} m^2",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
        "valid_queries": int(valid.sum()), "found": int(inside.sum()),
    }


def check_moments(torch, tmom, query, radius):
    """Kernel B1 against its plain version on one main-path call."""
    r2 = (radius * radius).reshape(1).to(torch.float32)
    cnt, ids = tmom.prune(query, query, r2)
    q, t = tmom.pack_operands(query, query)
    before = tmom.launches
    k = tmom.moments_visits(cnt, ids, r2, q, t)
    torch.cuda.synchronize()
    p = tmom.moments_visits_plain(cnt, ids, r2, q, t)
    tmom.launches = before
    valid = torch.all(q[:, :3].abs() < 1e7, dim=1) & (q[:, 3] > 0)
    kv, pv = k[valid].double(), p[valid].double()
    rel = ((kv - pv).abs() / pv.abs().clamp(min=1e-30))
    err = float((kv - pv).abs().max())
    count_mismatches = int((k[valid][:, 9] != p[valid][:, 9]).sum())
    ok = bool((rel <= MOMENT_RTOL).all()) and count_mismatches == 0
    visited = int(cnt.sum()) * tmom.BQ * tmom.MBT
    inside = int(p[valid][:, 9].sum())
    ms = device_time_ms(torch, lambda: tmom.moments_visits(cnt, ids, r2, q, t))
    tmom.launches = before
    plain_ms = device_time_ms(torch, lambda: tmom.moments_visits_plain(cnt, ids, r2, q, t), reps=5)
    nbytes = (q.numel() + t.numel() + cnt.numel() + ids.numel() + 1) * 4 + q.shape[0] * tmom.NM * 4
    # 8 ops per visited pair (3 mul, 4 add, compare) + 16 per pair inside
    # the radius (6 products, 10 sums)
    b, by = bound_ms(visited * 8 + inside * 16, nbytes)
    return ok, {
        "name": "moments_visits", "route": "cuda", "source": "locus_tpu_torch/csrc/moments.cu",
        "replaces": "locus_tpu/ops/pallas/moments.py:191",
        "queries": query.shape[0], "targets": query.shape[0], "bt": tmom.MBT,
        "radius": float(radius), "visited_pairs": visited, "pairs_in_radius": inside,
        "max_abs_err": err, "count_mismatches": count_mismatches,
        "tolerance": f"sums rtol {MOMENT_RTOL}, counts equal",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card and has no CPU path", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import locus_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the locus_tpu_torch package is not beside this script: {e}", file=sys.stderr)
        return 2
    if Path(locus_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print("chip_smoke: locus_tpu_torch was imported from outside this checkout", file=sys.stderr)
        return 2
    if "jax" in sys.modules or "locus_tpu" in sys.modules:
        print("chip_smoke: JAX or locus_tpu got imported", file=sys.stderr)
        return 2

    import numpy as np

    from locus_tpu_torch import config as cfg_mod, runner
    from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud
    from locus_tpu_torch.io.dataset import make_tunnel_sequence
    from locus_tpu_torch.metrics import ate_rmse
    from locus_tpu_torch.ops import dispatch, filters, voxel
    from locus_tpu_torch.ops.kernels import build, moments as tmom, nn as tnn

    record = {}
    dev = torch.device("cuda")
    try:
        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        record["device"] = {
            "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi_line,
            "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
        }
        emit(record["device"])

        # 2. build
        t0 = time.perf_counter()
        secs = build.build()
        record["build"] = {
            "phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": secs,
            "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln or "smem" in ln] for k, v in build.build_logs.items()},
        }
        emit(record["build"])

        cfg = production_config(cfg_mod)
        t0 = time.perf_counter()
        seq = make_tunnel_sequence(num_scans=SCANS, azimuth_steps=1800, step=0.35, seed=0)
        data_s = time.perf_counter() - t0

        # 3. reference: the plain versions on the card
        t0 = time.perf_counter()
        with dispatch.no_kernels():
            ref_poses, _, _, ref_state = runner.run_sequence(
                seq, cfg, max_scans=REF_SCANS, return_state=True, device=dev
            )
        record["reference"] = {"phase": "reference", "scans": REF_SCANS, "seconds": time.perf_counter() - t0, "data_seconds": data_s}
        emit(record["reference"])

        # 4. kernels at the main path's shapes, inputs from the reference state
        args = runner.scan_inputs(seq, REF_SCANS, cfg, dev)
        raw = PointCloud(torch.where(args[1][:, None], args[0], PAD_COORD), torch.zeros_like(args[0]),
                         torch.zeros(args[0].shape[0], device=dev), args[1])
        leaf = ref_state.voxel_leaf
        pc = filters.crop_box(raw, cfg.filtering.box_min, cfg.filtering.box_max)
        pc = voxel.voxel_downsample(pc, leaf, capacity=cfg.scan_capacity, with_attributes=False)
        scan_ref = ref_state.odom.reference
        results, oks = [], []
        ok, res = check_moments(torch, tmom, pc.xyz, cfg.filtering.normals_radius_scale * leaf)
        oks.append(ok), results.append(res)
        t_aug = tnn.build_nn_target(scan_ref.xyz, bt=tnn.SCAN_BT)
        c_min, c_max = tnn.chunk_boxes(scan_ref.xyz, scan_ref.mask, t_aug.shape[0], bt=tnn.SCAN_BT)
        q_scan = torch.where(pc.mask[:, None], pc.xyz, PAD_COORD)
        ok, res = check_nn(
            torch, tnn, "nn_visits_scan", q_scan, t_aug, scan_ref.xyz, c_min, c_max,
            cfg.odometry.corr_dist, tnn.SCAN_BT,
            lambda: torch.cdist(q_scan, scan_ref.xyz).min(1),
        )
        oks.append(ok), results.append(res)
        mp = ref_state.map
        world = pc.transform(ref_state.loc.integrated).xyz
        ok, res = check_nn(
            torch, tnn, "nn_visits_map", world, mp.nn_aug, mp.cloud.xyz, mp.chunk_min, mp.chunk_max,
            cfg.mapper.ann_search_radius, tnn.BT,
            lambda: torch.cdist(world, mp.cloud.xyz).min(1),
        )
        oks.append(ok), results.append(res)
        record["kernels"] = {"phase": "kernels", "checks": results, "map_points": int(mp.cloud.mask.sum())}
        emit(record["kernels"])
        if not all(oks):
            raise RuntimeError("a kernel disagrees with its plain version")

        # 5. pipeline through the kernels, launch counts of this run only
        tnn.launches.update({bt: 0 for bt in tnn.launches})
        tmom.launches = 0
        t0 = time.perf_counter()
        poses, outputs, report = runner.run_sequence(seq, cfg, device=dev)
        wall = time.perf_counter() - t0
        launches = {
            "moments_visits": tmom.launches,
            "nn_visits_scan": tnn.launches[tnn.SCAN_BT],
            "nn_visits_map": tnn.launches[tnn.BT],
        }
        dur = np.asarray(report.durations)
        gt = seq.gt_poses[: poses.shape[0]]
        ate = ate_rmse(poses[:, :3, 3], gt[:, :3, 3], align=False)
        record["pipeline"] = {
            "phase": "pipeline", "scans": int(poses.shape[0]),
            "scans_per_s_last32": RATE_WINDOW / float(dur[-RATE_WINDOW:].sum()),
            "ms_per_scan_p50_last32": float(np.median(dur[-RATE_WINDOW:]) * 1e3),
            "ms_per_scan_max_last32": float(dur[-RATE_WINDOW:].max() * 1e3),
            "first_scan_s": float(dur[0]), "wall_s": wall, "ate_m": ate,
            "launches": launches, "launches_per_scan": {k: v / poses.shape[0] for k, v in launches.items()},
            "keyframes": int(sum(o["keyframe_inserted"] for o in outputs)),
            "final_map_size": outputs[-1]["map_size"], "mean_points": float(np.mean([o["num_points"] for o in outputs])),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        emit(record["pipeline"])
        if min(launches.values()) <= 0:
            raise RuntimeError(f"the pipeline did not launch every kernel: {launches}")
        if not np.isfinite(poses).all() or ate > ATE_LIMIT_M:
            raise RuntimeError(f"ATE {ate} m exceeds {ATE_LIMIT_M} m")

        # 6. A/B against the plain versions
        ab = np.abs(poses[:REF_SCANS, :3, 3] - ref_poses[:, :3, 3]).max(axis=1)
        # rotation entries differ by about the angle between the two
        rot = float(np.abs(poses[:REF_SCANS, :3, :3] - ref_poses[:, :3, :3]).max())
        record["ab"] = {"phase": "ab", "scans": REF_SCANS, "max_translation_m": float(ab.max()),
                        "max_rotation_entry": rot, "per_scan_m": ab.tolist()}
        emit(record["ab"])
        if ab.max() > AB_LIMIT_M:
            raise RuntimeError(f"A/B: kernels and plain versions differ by {ab.max()} m")
    except Exception:
        traceback.print_exc()
        emit({"phase": "failed", "completed": list(record)})
        return 1

    counts = record["pipeline"]["launches"]
    summary = [
        {k: v for k, v in r.items() if k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
        | {"launches": counts[r["name"]]}
        for r in record["kernels"]["checks"]
    ]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    emit({"kernels": summary})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
