#!/usr/bin/env python3
"""Interleaved A/B of the pruned radius-moments kernel (B1/B4,
`csrc/moments.cu`): a base source against the checkout's, on the inputs of
chip_smoke.py's `kernels` phase, in one process on one CUDA card.

The base is another version of `moments.cu` with the checkout's pruned
entries: `locus_moments_visits(q, t, cnt, ids, r2, tiles, chunks, bt, out,
stream)` and `locus_moments_visits_batched(q, t, cnt, ids, r2, batch,
tiles, chunks, bt, out, stream)` (PR 3's is the one-block-per-tile
kernel). It is built with the checkout's nvcc flags into `build/ab/`
(`tools/torch_nn_ab.py`'s builder), and so is the checkout's source with
-DLOCUS_MOMENTS_SWEEP, whose `locus_moments_visits_sweep` launches any
instance (query splits x warps a quarter, INSTANCES below). The inputs are
the B1 call on scan 8 of the production tunnel and the B4 call on tick 8
of the 4-robot replay, from the plain reference replays, as chip_smoke.py
makes them. For each call the tool checks the base, the checkout's kernel
and every instance of the sweep build against the plain version (the ten
sums equal on every row), times base, new, new, base (`--rounds` times;
median of 20 CUDA-event timings each, chip_smoke's `device_time_ms`),
times the empty kernel on each kernel's grid (the launch floor), and times
every instance.

    python tools/torch_moments_ab.py --base build/ab/moments_base.cu [--rounds 2]
        [--out chiprun_out/moments_ab.json]

Imports neither JAX nor locus_tpu; needs a CUDA device.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (query splits, warps a quarter): 64 / splits queries a block, 128 threads
# a warp a quarter, one or two octets of queries a warp
INSTANCES = ((1, 4), (1, 8), (2, 2), (2, 4), (4, 1), (4, 2), (8, 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the base moments.cu")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of base, new, new, base")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "moments_ab.json"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_moments_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs
    from torch_nn_ab import build_base

    from locus_tpu_torch import config as cfg_mod, pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence
    from locus_tpu_torch.ops import dispatch
    from locus_tpu_torch.ops.kernels import build, moments as tmom

    dev = torch.device("cuda")
    build.build(build.KERNELS + (build.FLOOR,))
    base_lib = build_base(build, Path(args.base))
    sweep_fn = build_base(build, build.SRC_DIR / "moments.cu", ("-DLOCUS_MOMENTS_SWEEP",)).locus_moments_visits_sweep
    sweep_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    sweep_fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    cfg = cs.production_config(cfg_mod)
    seq = make_tunnel_sequence(num_scans=cs.SCANS, azimuth_steps=1800, step=0.35, seed=0)
    robot_seqs = [make_tunnel_sequence(num_scans=cs.ROBOT_SCANS, azimuth_steps=1800, step=st, seed=b)
                  for b, st in enumerate(cs.ROBOT_STEPS)]
    with dispatch.no_kernels():
        _, _, _, state = runner.run_sequence(seq, cfg, max_scans=cs.REF_SCANS, return_state=True, device=dev)
    packed = runner.stack_packed([
        {k: v[: cs.REF_SCANS] for k, v in runner.pack_sequence(s, cfg, device=dev).items()} for s in robot_seqs
    ])
    states, _ = runner.make_batched_replay(cfg, use_pallas=False)(
        pipeline.init_states(cfg, np.stack([s.gt_poses[0] for s in robot_seqs]), device=dev), packed
    )
    scale = cfg.filtering.normals_radius_scale
    cases = [
        ("moments_visits", cs.scan_for_checks(torch, cfg, [seq], cs.REF_SCANS, state.voxel_leaf, dev).xyz,
         scale * state.voxel_leaf),
        ("moments_visits_batched", cs.scan_for_checks(torch, cfg, robot_seqs, cs.REF_SCANS, states.voxel_leaf, dev).xyz,
         scale * states.voxel_leaf),
    ]

    rows = []
    for name, query, radius in cases:
        batched = query.dim() == 3
        batch = query.shape[0] if batched else 1
        r2 = (radius * radius).reshape(-1).to(torch.float32)
        cnt, ids = tmom.prune(query, query, r2)
        q, t = tmom.pack_operands(query, query)
        num_tiles, num_chunks = q.shape[-2] // tmom.BQ, t.shape[-2] // tmom.MBT
        base_fn = getattr(base_lib, f"locus_{name}")
        base_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (4 if batched else 3) + [ctypes.c_void_p] * 2
        base_fn.restype = ctypes.c_int
        sizes = ((batch,) if batched else ()) + (num_tiles, num_chunks, tmom.MBT)

        def base():
            out = torch.empty(q.shape[:-1] + (tmom.NM,), dtype=torch.float32, device=dev)
            build.check(base_fn(q.data_ptr(), t.data_ptr(), cnt.data_ptr(), ids.data_ptr(), r2.data_ptr(),
                                *sizes, out.data_ptr(), stream), name)
            return out

        def new():
            return tmom._moments_cuda("visits", cnt, ids, r2, q, t, tmom.MBT, batched)

        def sweep(qs, warps):
            out = torch.empty(q.shape[:-1] + (tmom.NM,), dtype=torch.float32, device=dev)
            build.check(sweep_fn(q.data_ptr(), t.data_ptr(), cnt.data_ptr(), ids.data_ptr(), r2.data_ptr(),
                                 batch, num_tiles, num_chunks, tmom.MBT, qs, warps, out.data_ptr(), stream),
                        f"locus_moments_visits_sweep {qs}:{warps}")
            return out

        plain = tmom.moments_visits_plain(cnt, ids, r2, q, t)
        instances = {f"{qs}:{w}": (lambda p=(qs, w): sweep(*p)) for qs, w in INSTANCES}
        mismatches = {"base": base, "new": new} | instances
        for label, fn in mismatches.items():
            out = fn()
            torch.cuda.synchronize()
            mismatches[label] = int((out != plain).sum())
        times = {"base": [], "new": []}
        for _ in range(args.rounds):
            for label in ("base", "new", "new", "base"):
                times[label].append(cs.device_time_ms(torch, base if label == "base" else new))
        sweep = {label: cs.device_time_ms(torch, fn) for label, fn in instances.items()}
        grid, threads = tmom.launch_grid("visits", batch, num_tiles)
        visited = int(cnt.sum()) * tmom.BQ * tmom.MBT
        inside = int(plain[..., 9].sum())
        nbytes = ((q.numel() + t.numel() + r2.numel() + cnt.numel() + ids.numel()) * 4
                  + q.shape[:-1].numel() * tmom.NM * 4)
        bound, by = cs.bound_ms(visited * 8 + inside * 16, nbytes)
        row = {
            "name": name, "batch": batch, "radius": radius.reshape(-1).tolist(), "visited_pairs": visited,
            "pairs_in_radius": inside, "max_visits_per_tile": int(cnt.max()),
            "mean_visits_per_tile": float(cnt.float().mean()), "empty_tiles": int((cnt == 0).sum()),
            "mismatches_vs_plain": mismatches, "base_ms": times["base"], "new_ms": times["new"],
            "base_ms_median": float(np.median(times["base"])), "new_ms_median": float(np.median(times["new"])),
            "speedup": float(np.median(times["base"]) / np.median(times["new"])),
            "splits": list(tmom.SPLIT), "grid": list(grid), "threads": threads,
            "floor_ms": cs.floor_ms(torch, build, grid, threads),
            "base_floor_ms": cs.floor_ms(torch, build, (num_tiles, batch, 1), 256),  # its one block a tile
            "bound_ms": bound, "bound_by": by, "new_ms_by_instance": sweep,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "base": args.base,
              "rounds": args.rounds, "rows": rows}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}
                     | {"speedup": {r["name"]: r["speedup"] for r in rows},
                        "mismatches": {r["name"]: r["mismatches_vs_plain"] for r in rows}}))
    return 0 if all(not any(r["mismatches_vs_plain"].values()) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
