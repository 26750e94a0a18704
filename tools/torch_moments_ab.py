#!/usr/bin/env python3
"""Interleaved A/B of the radius-moments kernels (`csrc/moments.cu`): a base
source against the checkout's, on the inputs of chip_smoke.py's `kernels`
phase, in one process on one CUDA card.

`--kind visits` (the default) takes the pruned kernel, B1/B4: the base is
another version of `moments.cu` with the checkout's pruned entries,
`locus_moments_visits(q, t, cnt, ids, r2, tiles, chunks, bt, out, stream)`
and `locus_moments_visits_batched(q, t, cnt, ids, r2, batch, tiles, chunks,
bt, out, stream)` (an older one-block-per-tile kernel has them too), and the sweep
build's `locus_moments_visits_sweep` launches any instance (query splits x
warps a quarter, INSTANCES below). `--kind dense` takes the dense kernel,
B5/B6: the base has the dense entries without scratch,
`locus_moments_dense(q, t, r2, tiles, chunks, bt, out, stream)` and
`locus_moments_dense_batched(q, t, r2, batch, tiles, chunks, bt, out,
stream)` (the older one-block-a-tile kernel), and `locus_moments_dense_sweep`
launches any (target splits, octets a warp) instance (DENSE_INSTANCES
below).

The base and the checkout's source with -DLOCUS_MOMENTS_SWEEP are built
with the checkout's nvcc flags into `build/ab/` (`tools/torch_nn_ab.py`'s
builder). The inputs are the B1 call on scan 8 of the production tunnel
and the B4 call on tick 8 of the 4-robot replay, from the plain reference
replays, as chip_smoke.py makes them (B5 and B6 take the same points in
1024-point chunks). For each call the tool checks the base, the checkout's
kernel and every instance of the sweep build against the plain version
(the ten sums equal on every row), times base, new, new, base (`--rounds`
times; median of 20 CUDA-event timings each, chip_smoke's
`device_time_ms`), times the empty kernel on each kernel's grid (the
launch floor), and times every instance; for the dense kernel also the
checkout's at r^2 = -1, where no pair passes (the cost of all but the
sums).

    python tools/torch_moments_ab.py --base build/ab/moments_base.cu
        [--kind visits|dense] [--rounds 2] [--out chiprun_out/moments_<kind>_ab.json]

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
# (target splits, octets of queries a warp): 1024 / octets threads a block
DENSE_INSTANCES = ((8, 4), (8, 2), (4, 4), (16, 4))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the base moments.cu")
    ap.add_argument("--kind", choices=("visits", "dense"), default="visits",
                    help="the pruned kernel (B1/B4) or the dense one (B5/B6)")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of base, new, new, base")
    ap.add_argument("--out", help="the record (default chiprun_out/moments_<kind>_ab.json)")
    args = ap.parse_args()
    dense = args.kind == "dense"

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
    logs = {}
    base_lib = build_base(build, Path(args.base), logs=logs)
    sweep_lib = build_base(build, build.SRC_DIR / "moments.cu", ("-DLOCUS_MOMENTS_SWEEP",), logs=logs)
    logs["moments (checkout)"] = build.build_logs.get("moments", "")
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln or "Compiling" in ln]
             for k, v in logs.items()}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    if dense:
        sweep_fn = sweep_lib.locus_moments_dense_sweep
        sweep_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    else:
        sweep_fn = sweep_lib.locus_moments_visits_sweep
        sweep_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    sweep_fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    cfg = cfg_mod.production_config()
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
    names = ("moments_dense", "moments_dense_batched") if dense else ("moments_visits", "moments_visits_batched")
    cases = [
        (names[0], cs.scan_for_checks(torch, cfg, [seq], cs.REF_SCANS, state.voxel_leaf, dev).xyz,
         scale * state.voxel_leaf),
        (names[1], cs.scan_for_checks(torch, cfg, robot_seqs, cs.REF_SCANS, states.voxel_leaf, dev).xyz,
         scale * states.voxel_leaf),
    ]

    rows = []
    for name, query, radius in cases:
        batched = query.dim() == 3
        batch = query.shape[0] if batched else 1
        r2 = (radius * radius).reshape(-1).to(torch.float32)
        bt = tmom.DENSE_BT if dense else tmom.MBT
        q, t = tmom.pack_operands(query, query, bt=bt)
        cnt, ids = tmom.dense_visits(q, t) if dense else tmom.prune(query, query, r2)
        num_tiles, num_chunks = q.shape[-2] // tmom.BQ, t.shape[-2] // bt
        sizes = ((batch,) if batched else ()) + (num_tiles, num_chunks, bt)
        base_fn = getattr(base_lib, f"locus_{name}")
        pointers = (q, t, r2) if dense else (q, t, cnt, ids, r2)
        base_fn.argtypes = [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(sizes) + [ctypes.c_void_p] * 2
        base_fn.restype = ctypes.c_int

        def base():
            out = torch.empty(q.shape[:-1] + (tmom.NM,), dtype=torch.float32, device=dev)
            build.check(base_fn(*(p.data_ptr() for p in pointers), *sizes, out.data_ptr(), stream), name)
            return out

        def new():
            return (tmom.moments_dense_batched if batched else tmom.moments_dense)(r2, q, t) if dense \
                else tmom._moments_cuda("visits", cnt, ids, r2, q, t, bt, batched)

        def sweep(*inst):
            out = torch.empty(q.shape[:-1] + (tmom.NM,), dtype=torch.float32, device=dev)
            if dense:
                splits, octets = inst
                buffers = (tmom.dense_scratch(batch, num_tiles, splits, dev),
                           tmom._merge_counters(dev, batch * num_tiles))
                status = sweep_fn(q.data_ptr(), t.data_ptr(), r2.data_ptr(), batch, num_tiles, num_chunks, bt,
                                  splits, octets, *(m.data_ptr() for m in buffers),
                                  out.data_ptr(), stream)
            else:
                status = sweep_fn(q.data_ptr(), t.data_ptr(), cnt.data_ptr(), ids.data_ptr(), r2.data_ptr(),
                                  batch, num_tiles, num_chunks, bt, *inst, out.data_ptr(), stream)
            build.check(status, f"{sweep_fn.__name__} {inst}")
            return out

        plain = tmom.moments_visits_plain(cnt, ids, r2, q, t, bt)
        instances = {":".join(map(str, inst)): (lambda p=inst: sweep(*p))
                     for inst in (DENSE_INSTANCES if dense else INSTANCES)}
        mismatches = {"base": base, "new": new} | instances
        for label, fn in mismatches.items():
            out = fn()
            torch.cuda.synchronize()
            mismatches[label] = int((out != plain).sum())
        times = {"base": [], "new": []}
        for _ in range(args.rounds):
            for label in ("base", "new", "new", "base"):
                times[label].append(cs.device_time_ms(torch, base if label == "base" else new))
        by_instance = {label: cs.device_time_ms(torch, fn) for label, fn in instances.items()}
        grid, threads = tmom.launch_grid(args.kind, batch, num_tiles)
        visited = q.shape[:-1].numel() * t.shape[-2] if dense else int(cnt.sum()) * tmom.BQ * tmom.MBT
        inside = int(plain[..., 9].sum())
        nbytes = (q.numel() + t.numel() + r2.numel()) * 4 + q.shape[:-1].numel() * tmom.NM * 4
        if not dense:
            nbytes += (cnt.numel() + ids.numel()) * 4
        bound, by = cs.bound_ms(visited * 8 + inside * 16, nbytes)
        row = {
            "name": name, "kind": args.kind, "batch": batch, "radius": radius.reshape(-1).tolist(),
            "visited_pairs": visited, "pairs_in_radius": inside,
            "mismatches_vs_plain": mismatches, "base_ms": times["base"], "new_ms": times["new"],
            "base_ms_median": float(np.median(times["base"])), "new_ms_median": float(np.median(times["new"])),
            "speedup": float(np.median(times["base"]) / np.median(times["new"])),
            "splits": list(tmom.DENSE_SPLIT if dense else tmom.SPLIT), "grid": list(grid), "threads": threads,
            "floor_ms": cs.floor_ms(torch, build, grid, threads),
            "base_floor_ms": cs.floor_ms(torch, build, (num_tiles, batch, 1), 256),  # its one block a tile
            "bound_ms": bound, "bound_by": by, "new_ms_by_instance": by_instance,
        }
        if dense:
            # at r^2 = -1 no pair passes (sentinel pairs score 0): the gates,
            # the staging and the merge without any sum
            none = torch.full_like(r2, -1.0)
            row["new_ms_no_pair_inside"] = cs.device_time_ms(
                torch, lambda: tmom._moments_cuda("dense", None, None, none, q, t, bt, batched))
        else:
            row |= {"max_visits_per_tile": int(cnt.max()), "mean_visits_per_tile": float(cnt.float().mean()),
                    "empty_tiles": int((cnt == 0).sum())}
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "base": args.base, "kind": args.kind,
              "rounds": args.rounds, "ptxas": ptxas, "rows": rows}
    out = Path(args.out or ROOT / "chiprun_out" / f"moments_{args.kind}_ab.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k not in ("rows", "ptxas")}
                     | {"speedup": {r["name"]: r["speedup"] for r in rows},
                        "mismatches": {r["name"]: r["mismatches_vs_plain"] for r in rows}}))
    return 0 if all(not any(r["mismatches_vs_plain"].values()) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
