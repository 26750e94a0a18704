"""Multi-rank cases of the port's sharded deployments on the CPU, for
tests/test_torch_parallel.py, test_torch_sharded_replay.py and
test_torch_sharded_live.py. Imports no JAX: the ranks are gloo processes
with one torch thread each, joined through a FileStore in the test's
tmp_path, and every launch has a deadline after which its ranks are
ended (`distributed.spawn_ranks`).

- `launch_tool` runs tools/torch_dist_smoke.py's modes as ranks and
  returns rank 0's JSON line;
- `launch_cases` runs this module's own rank program (`python -m
  tests.torch_ranks`) on inputs saved by the test, and returns each rank's
  outputs: the unit cases against a map split over 4 ranks ("unit") and a
  served session's closure push-back on 2 ranks ("live_closure").
"""
import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "torch_dist_smoke.py"


def _check(results):
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    return results


def launch_tool(tmp_path, world: int, *args, timeout: float = 240.0) -> dict:
    """tools/torch_dist_smoke.py on `world` CPU ranks; rank 0's record."""
    from locus_tpu_torch.parallel.distributed import spawn_ranks

    out = Path(tmp_path)
    cmd = [sys.executable, str(TOOL), *map(str, args), "--device", "cpu", "--out", str(out), "--timeout", str(timeout)]
    results = _check(spawn_ranks(cmd, world, out / f"ranks_{args[1] if len(args) > 1 else 'x'}", timeout, cwd=ROOT))
    return json.loads(results[0][1].strip().splitlines()[-1])


def launch_cases(tmp_path, group: str, world: int, inputs: dict, timeout: float = 240.0) -> list:
    """This module's rank program for case group `group` on `inputs`
    (arrays, saved for the ranks); each rank's outputs as a dict."""
    from locus_tpu_torch.parallel.distributed import spawn_ranks

    work = Path(tmp_path) / group
    work.mkdir(parents=True, exist_ok=True)
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "tests.torch_ranks", "--group", group, "--dir", str(work)]
    _check(spawn_ranks(cmd, world, work / "ranks", timeout, env=env, cwd=ROOT))
    outs = []
    for r in range(world):
        with np.load(work / f"out{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


# -- the rank program ------------------------------------------------------

def unit_cases(torch, mesh, x: dict) -> dict:
    """The sharded 1-NN family, the shard specs' split, the sharded pose
    graph, a sharded map's insert and re-anchor, and the sharded checkpoint,
    on a map split over every rank of a (1, S) mesh."""
    from locus_tpu_torch import checkpoint, pipeline
    from locus_tpu_torch.config import LocusConfig, MapperConfig
    from locus_tpu_torch.core.cloud import PointCloud
    from locus_tpu_torch.mapping import keyframe_map as km
    from locus_tpu_torch.ops.dispatch import shard_context
    from locus_tpu_torch.ops.kernels.nn import build_nn_target, chunk_boxes
    from locus_tpu_torch.parallel import posegraph as pg
    from locus_tpu_torch.parallel import sharded_map
    from locus_tpu_torch.parallel.mesh import Mesh, gather_state, shard_state

    S, i = mesh.shape["map"], mesh.map_index
    t = {k: torch.from_numpy(v) for k, v in x.items() if v.dtype.kind in "fiub"}

    def mine(a):
        n = a.shape[0] // S
        return a[i * n: (i + 1) * n]

    out = {}
    out["knn_d2"], out["knn_idx"] = sharded_map.sharded_knn(mesh, t["knn_q"], mine(t["knn_m"]), k=8)
    out["nearest_d2"], out["nearest_idx"] = sharded_map.sharded_nearest(mesh, t["near_q"], mine(t["near_m"]))
    xyz = t["pallas_m"]
    aug = build_nn_target(xyz)
    c_min, c_max = chunk_boxes(xyz, torch.ones(xyz.shape[0], dtype=torch.bool), aug.shape[0])
    shard = (mine(xyz), mine(aug), mine(c_min), mine(c_max))
    out["pallas_d2"], out["pallas_idx"] = sharded_map.sharded_nearest_pallas(mesh, t["pallas_q"], *shard, radius=50.0)
    out["pallas_far_d2"], _ = sharded_map.sharded_nearest_pallas(mesh, t["pallas_q"] + 1000.0, *shard, radius=2.0)
    g = pg.make_graph(t["pg_est"], t["pg_fi"], t["pg_fj"], t["pg_fT"], factor_mask=t["pg_mask"], device="cpu")
    out["pg_poses"] = pg.optimize_sharded(mesh, g, iterations=8, cg_iterations=30).poses

    # a map of S x BT slots: three keyframes inserted shard by shard, then
    # re-anchored where each shard lies, then gathered
    cap = int(x["map_capacity"])
    mcfg = MapperConfig(map_capacity=cap, keyframe_capacity=256, map_voxel_leaf=0.05)
    mp = shard_state(mesh, km.init_map(mcfg, device="cpu"), cap, at_map_root=True)
    with shard_context(mesh):
        for k in range(3):
            mp = km.insert_keyframe(mp, PointCloud.from_points(x["kf_points"][k], capacity=256), mcfg)
        out["map_size"] = km.map_size(mp)
    inserted = gather_state(mesh, mp, cap, at_map_root=True)
    moved = gather_state(mesh, km.reanchor(mp, t["corrections"], mcfg), cap, at_map_root=True)
    for name, m in (("inserted", inserted), ("reanchored", moved)):
        for f in ("xyz", "normals", "mask"):
            out[f"{name}_{f}"] = getattr(m.cloud, f)
        for f in ("nn_aug", "chunk_min", "chunk_max", "kf_index", "write_ptr"):
            out[f"{name}_{f}"] = getattr(m, f)

    # the sharded checkpoint round trip, and a resume on another layout
    cfg = LocusConfig(mapper=MapperConfig(map_capacity=cap, keyframe_capacity=256, map_voxel_leaf=0.05))
    state = shard_state(mesh, pipeline.init_state(cfg, device="cpu"), cap)
    state = state._replace(map=mp)
    prefix = str(Path(x["dir"].item()) / "ck")
    checkpoint.save_state_sharded(prefix, state, mesh, cap)
    template = shard_state(mesh, pipeline.init_state(cfg, device="cpu"), cap)
    restored = checkpoint.load_state_sharded(prefix, template, mesh, cap)
    pairs = zip(checkpoint.leaves_with_paths(state), checkpoint.leaves_with_paths(restored))
    out["ckpt_leaves_equal"] = np.asarray([bool(torch.equal(a, b)) for (_, a), (_, b) in pairs])
    other = Mesh(1, 1, mesh.rank, mesh.device, mesh.backend)      # the same files, read as a one-shard layout
    try:
        checkpoint.load_state_sharded(prefix, pipeline.init_state(cfg, device="cpu"), other, cap)
        out["ckpt_layout_error"] = np.asarray("")
    except ValueError as e:
        out["ckpt_layout_error"] = np.asarray(str(e))
    return out


def live_closure_cases(torch, mesh, x: dict) -> dict:
    """tests/test_live.py::test_live_apply_loop_closure_sharded_matches_unsharded
    on the port: a session served 3 scans with its map split over the ranks,
    then a closure pushed back (each shard re-anchored where it lies); the
    whole map gathered, and the pose. Also a session resumed from the
    sharded checkpoint written after scan 1, serving scan 2."""
    from locus_tpu_torch.config import FilterConfig, FusionConfig, LocusConfig, MapperConfig
    from locus_tpu_torch.io.dataset import Sequence
    from locus_tpu_torch.live import LiveSession

    cfg = LocusConfig(
        scan_capacity=256, raw_scan_capacity=1024, points_to_process_in_callback=200,
        filtering=FilterConfig(normals_k=8),
        mapper=MapperConfig(map_capacity=4096, keyframe_capacity=256, map_voxel_leaf=0.1),
        fusion=FusionConfig(data_integration_mode=0), b_enable_computation_time_profiling=False,
    )
    seq = Sequence.load(str(x["seq"].item()))
    prefix = str(Path(x["dir"].item()) / "live_ck")
    s = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0], mesh=mesh, device="cpu", checkpoint_path=prefix,
                    checkpoint_every=2)

    def serve(sess, k):
        return sess.process_scan(float(seq.stamps[k]), seq.scans[k], seq.scan_valid[k])[0]

    poses = [serve(s, k) for k in range(3)]
    # a session resumed from the checkpoint written after scan 1 repeats scan 2
    again = LiveSession(cfg=cfg, initial_pose=seq.gt_poses[0], mesh=mesh, device="cpu")
    again.resume(prefix)
    s.apply_loop_closure(x["corrected"], x["corr"])
    whole = s._whole_map()
    return {"poses": np.stack(poses), "xyz": whole.cloud.xyz, "mask": whole.cloud.mask,
            "pose_after": s.state.loc.integrated, "local_points": s.state.map.cloud.capacity,
            "resumed_pose": serve(again, 2), "resumed_scan_count": again._scan_count}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--group", choices=("unit", "live_closure"), required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-file", required=True)
    args = ap.parse_args()

    import torch

    torch.set_num_threads(1)
    from locus_tpu_torch.parallel.distributed import destroy, init_distributed
    from locus_tpu_torch.parallel.mesh import make_mesh

    init_distributed(init_method=f"file://{os.path.abspath(args.init_file)}", world_size=args.world_size,
                     rank=args.rank, backend="gloo", timeout_s=120)
    try:
        mesh = make_mesh(args.world_size, map_parallel=args.world_size, device_type="cpu", backend="gloo")
        with np.load(Path(args.dir) / "inputs.npz") as z:
            x = {k: z[k] for k in z.files}
        x["dir"] = np.asarray(args.dir)
        run = unit_cases if args.group == "unit" else live_closure_cases
        out = run(torch, mesh, x)
    finally:
        destroy()
    np.savez(Path(args.dir) / f"out{args.rank}.npz",
             **{k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in out.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
