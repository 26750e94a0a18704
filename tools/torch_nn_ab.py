#!/usr/bin/env python3
"""Interleaved A/B of the visit-list 1-NN kernel (B2/B3, `csrc/nn.cu`): a
base source against the checkout's, on the inputs of chip_smoke.py's
`kernels` phase, in one process on one CUDA card.

The base is another version of `nn.cu` whose entries take no split
arguments: `locus_nn_visits(q, t, cnt, ids, tiles, chunks, bt, d, i,
stream)` and `locus_nn_visits_batched(q, t, cnt, ids, batch, tiles,
chunks, bt, d, i, stream)` (the one-block-per-tile kernel). It is built
with the checkout's nvcc flags into `build/ab/`. The inputs are the B2
(scan, map) calls of the 8-scan plain reference replay and the B3 calls of
the 8-tick 4-robot one, plus B3 map at B = 16, as chip_smoke.py makes
them. For each call the tool checks both kernels against the plain version
bit for bit, times base, new, new, base (`--rounds` times; median of 20
CUDA-event timings each, chip_smoke's `device_time_ms`), times the empty
kernel on each kernel's grid (the launch floor), and times the new kernel
at each (query splits, target splits) pair in `--splits`.

    python tools/torch_nn_ab.py --base build/ab/nn_base.cu [--rounds 2]
        [--splits 1:1,1:4,1:16,4:1] [--out chiprun_out/nn_ab.json]

Imports neither JAX nor locus_tpu; needs a CUDA device.
"""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def build_base(build, src: Path, flags: tuple[str, ...] = (), logs: dict | None = None) -> ctypes.CDLL:
    """nvcc of the base source into build/ab/, with the checkout's flags
    and `flags`; the compiler's report goes to `logs[out file name]`."""
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = out_dir / f"lib{src.stem}-{digest}.so"
    if not out.exists():
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        if logs is not None:
            logs[out.name] = proc.stdout + proc.stderr
    return ctypes.CDLL(str(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the base nn.cu")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of base, new, new, base")
    ap.add_argument("--splits", default="1:1,1:2,1:4,1:8,1:16,2:1,4:1,2:2,4:2",
                    help="(query splits:target splits) pairs to time the new kernel at")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "nn_ab.json"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_nn_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from locus_tpu_torch import config as cfg_mod, pipeline, runner
    from locus_tpu_torch.io.dataset import make_tunnel_sequence
    from locus_tpu_torch.ops import dispatch
    from locus_tpu_torch.ops.kernels import build, nn as tnn

    dev = torch.device("cuda")
    build.build(build.KERNELS + (build.FLOOR,))
    base_lib = build_base(build, Path(args.base))
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
    pc = cs.scan_for_checks(torch, cfg, [seq], cs.REF_SCANS, state.voxel_leaf, dev)
    pcb = cs.scan_for_checks(torch, cfg, robot_seqs, cs.REF_SCANS, states.voxel_leaf, dev)
    cases = cs.nn_cases(torch, tnn, cfg, pc, state, "") + cs.nn_cases(torch, tnn, cfg, pcb, states, "_batched")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = [tuple(int(v) for v in pair.split(":")) for pair in args.splits.split(",")]

    rows = []
    for name, bt, radius, nn_args, _, _ in cases:
        cnt, ids, q, t_aug = nn_args
        batched = q.dim() == 3
        batch = q.shape[0] if batched else 1
        num_tiles, num_chunks = q.shape[-2] // tnn.BQ, t_aug.shape[-2] // bt
        entry = "locus_nn_visits_batched" if batched else "locus_nn_visits"
        base_fn = getattr(base_lib, entry)
        base_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (4 if batched else 3) + [ctypes.c_void_p] * 3
        base_fn.restype = ctypes.c_int
        sizes = (batch, num_tiles, num_chunks, bt) if batched else (num_tiles, num_chunks, bt)

        def base():
            d = torch.empty(q.shape[:-1], dtype=torch.float32, device=dev)
            i = torch.empty(q.shape[:-1], dtype=torch.int32, device=dev)
            build.check(base_fn(q.data_ptr(), t_aug.data_ptr(), cnt.data_ptr(), ids.data_ptr(), *sizes,
                                d.data_ptr(), i.data_ptr(), stream), entry)
            return d, i

        def new(num_splits=None):
            return tnn._nn_visits_cuda(cnt, ids, q, t_aug, bt, batched, num_splits)

        pd, pi = tnn.nn_visits_plain(cnt, ids, q, t_aug, bt)
        mismatches = {}
        for label, fn in (("base", base), ("new", new)):
            d, i = fn()
            torch.cuda.synchronize()
            mismatches[label] = int(((d.view(torch.int32) != pd.view(torch.int32)) | (i != pi)).sum())
        times = {"base": [], "new": []}
        for _ in range(args.rounds):
            for label in ("base", "new", "new", "base"):
                times[label].append(cs.device_time_ms(torch, base if label == "base" else new))
        grid = tnn.launch_grid(batch, num_tiles, num_chunks, bt, sms)
        most = num_chunks * bt // tnn.SUB
        sweep = {f"{qs}:{ts}": cs.device_time_ms(torch, lambda p=(qs, ts): new(p))
                 for qs, ts in splits if qs in tnn.QUERY_SPLITS and ts <= most}
        visited = int(cnt.sum()) * tnn.BQ * bt
        nbytes = (q.numel() + t_aug.numel() + cnt.numel() + ids.numel()) * 4 + q.shape[:-1].numel() * 8
        bound, by = cs.bound_ms(visited * 7, nbytes)
        row = {
            "name": name, "batch": batch, "bt": bt, "radius": float(radius), "visited_pairs": visited,
            "max_visits_per_tile": int(cnt.max()), "mean_visits_per_tile": float(cnt.float().mean()),
            "mismatches_vs_plain": mismatches, "base_ms": times["base"], "new_ms": times["new"],
            "base_ms_median": float(np.median(times["base"])), "new_ms_median": float(np.median(times["new"])),
            "speedup": float(np.median(times["base"]) / np.median(times["new"])),
            "grid": list(grid), "floor_ms": cs.floor_ms(torch, build, grid, tnn.THREADS),
            "splits": list(tnn.splits(batch, num_tiles, num_chunks, bt, sms)),
            "base_floor_ms": cs.floor_ms(torch, build, (num_tiles, batch, 1), 256),  # its one block per tile
            "bound_ms": bound, "bound_by": by, "new_ms_by_splits": sweep,
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
