"""Host-side replay runner (counterpart of `locus_tpu/runner.py`): per
scan it packs the raw scan to a fixed shape, pushes the sensor windows
into the device-resident fusion buffers and runs one pipeline step, then
collects the trajectory and diagnostics on the host.

Ported: `pack_scan`, the replay step (`replay_step` eagerly,
`make_replay_step` compiled: one CUDA graph a scan on the card),
`run_sequence` (with the online SLAM backend), the live step of one
upload and one fetch a scan (`make_live_step`, `unpack_live_output`),
and the prepacked replays: `pack_sequence`, `stack_packed`,
`make_scan_replay` (one sequence) and `make_batched_replay` (B sequences,
one batched step per tick). The JAX package runs those as one compiled
`lax.scan`; here a host loop steps through the prepacked device tensors,
replaying the captured step where `pipeline.capturable` holds (the
single and the batched replays; the live step and the mesh run the
eager step).

`mesh=` (a `parallel.mesh.Mesh`) runs the replays and the live step as
one rank of an SPMD process group: the state's map leaves are this rank's
shards (`mesh.shard_state`), the scans are replicated (or, batched, this
rank's data row of robots), and the map merges across the "map" axis
inside `dispatch.shard_context`. Every rank runs the same host loop on
the same replicated values, so all of them take the same iterations and
issue the same collectives.

`run_sequence` packs and uploads each scan on the thread that steps the
pipeline. The JAX package prepares the next scan on a second thread; here
that thread's uploads would reach the card while the step runs on it.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from locus_tpu_torch import fusion, localization, pipeline
from locus_tpu_torch.config import LocusConfig
from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud
from locus_tpu_torch.io.dataset import Sequence, sensor_windows_for_scan
from locus_tpu_torch.mapping.registry import mapper_fabric
from locus_tpu_torch.metrics import RateReport
from locus_tpu_torch.ops.dispatch import no_kernels, resolve_device, shard_context
from locus_tpu_torch.ops.graph import CapturedStep
from locus_tpu_torch.parallel.mesh import check_mesh


def pack_scan(xyz: np.ndarray, valid: np.ndarray, capacity: int):
    """Host-side fixed-shape packing of a raw scan (numpy, cheap)."""
    out = np.full((capacity, 3), PAD_COORD, np.float32)
    msk = np.zeros((capacity,), bool)
    sel = np.nonzero(valid)[0][:capacity]
    out[: sel.size] = xyz[sel]
    msk[: sel.size] = True
    return out, msk


def scan_inputs(seq: Sequence, i: int, cfg: LocusConfig, device):
    """The device tensors of scan i: (scan_xyz, scan_mask, stamp, imu_s,
    imu_q, odom_s, odom_p, seq_id), the arguments of `replay_step`."""
    xyz, mask = pack_scan(seq.scans[i], seq.scan_valid[i], cfg.raw_scan_capacity)
    (imu_s, imu_q), (odom_s, odom_p) = sensor_windows_for_scan(seq, i)
    host = (xyz, mask, np.float32(seq.stamps[i]), imu_s, imu_q, odom_s, odom_p, np.int32(i))
    return tuple(torch.as_tensor(a).to(device, non_blocking=True) for a in host)


def raw_cloud(scan_xyz: torch.Tensor, scan_mask: torch.Tensor) -> PointCloud:
    """The raw scan as the step takes it: sentinel on the masked lanes, no
    normals or intensity yet."""
    return PointCloud(
        torch.where(scan_mask[..., None], scan_xyz, PAD_COORD),
        torch.zeros_like(scan_xyz),
        torch.zeros(scan_mask.shape, dtype=torch.float32, device=scan_xyz.device),
        scan_mask,
    )


def replay_step(state, scan_xyz, scan_mask, stamp, imu_s, imu_q, odom_s, odom_p, seq_id, cfg: LocusConfig):
    """Sensor ingest + one pipeline step, eagerly (the function
    `locus_tpu/runner.py::make_replay_step` compiles; `make_replay_step`
    is its compiled counterpart)."""
    fuse = fusion.push_imu_batch(state.fuse, imu_s, imu_q)
    fuse = fusion.push_odom_batch(fuse, odom_s, odom_p)
    return pipeline.step(state._replace(fuse=fuse), raw_cloud(scan_xyz, scan_mask), stamp, cfg, seq=seq_id)


# the captured steps' names in their stamps (`ops.graph.replay_records`)
REPLAY_STEP, BATCHED_REPLAY_STEP = "runner.replay_step", "runner.batched_replay_step"


def make_replay_step(cfg: LocusConfig, device=None, name: str = REPLAY_STEP):
    """Sensor ingest + one pipeline step as one compiled function
    (counterpart of the JAX `make_replay_step`): rstep(state, scan_xyz,
    scan_mask, stamp, imu_s, imu_q, odom_s, odom_p, seq_id) -> (state,
    StepOutput), the arguments those of `replay_step` as device tensors
    (`scan_inputs`); one robot's state, or B robots' (`stack_states`)
    with inputs stacked the same way (a tick of `make_batched_replay`).

    On the card (`device` None or CUDA): the push of the IMU and odometry
    windows and the step, one CUDA graph a scan (`ops.graph.CapturedStep`
    named `name`; the scan, its mask, the stamp, the windows and the
    sequence number are its static inputs, and the first call fixes their
    shapes), where `pipeline.capturable(cfg)` holds, and
    NotImplementedError naming the option elsewhere. The returned state
    and outputs are the graph's static buffers, overwritten by the next
    call (JAX's donation): clone what you keep. On the CPU: `replay_step`,
    eagerly."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return functools.partial(replay_step, cfg=cfg)
    pipeline.check_capturable(cfg)
    return CapturedStep(functools.partial(replay_step, cfg=cfg), name, stamps=cfg.b_enable_computation_time_profiling)


def _stepper(cfg: LocusConfig, dev: torch.device, mesh=None, name: str = REPLAY_STEP):
    """(step function, captured): `make_replay_step`'s compiled step on the
    card where `pipeline.capturable(cfg, mesh)` holds, else the eager
    `replay_step`."""
    if dev.type == "cuda" and pipeline.capturable(cfg, mesh):
        return make_replay_step(cfg, dev, name), True
    return functools.partial(replay_step, cfg=cfg), False


def _kept(out: pipeline.StepOutput, captured: bool) -> pipeline.StepOutput:
    """A step's outputs to keep past the next step: a captured step's are
    its graph's static buffers, which the next replay overwrites."""
    return pipeline.StepOutput(*(x.clone() for x in out)) if captured else out


# The live step's packed output: the pose (16), the covariance (36), then
# these StepOutput fields, one f32 each.
LIVE_SCALARS = (
    "condition_number", "prior_source", "scan_to_scan_accepted", "scan_to_map_accepted",
    "keyframe_inserted", "msw_refreshed", "num_points", "voxel_leaf", "odom_iterations",
    "loc_iterations", "map_size", "xy_cross_section",
)


def live_aux_len(imu_window: int, odom_window: int) -> int:
    """Length of the live step's aux vector: stamp, scan counter, the IMU
    window (stamps, quaternions) and the odometry window (stamps, poses)."""
    return 2 + imu_window * 5 + odom_window * 17


def make_live_step(cfg: LocusConfig, imu_window: int, odom_window: int, mesh=None):
    """The streaming step (counterpart of the JAX `make_live_step`):
    rstep(state, scan_xyzm, aux) -> (state, packed) with ONE upload of the
    scan and its mask as a (cap, 4) f32 tensor and one flat f32 aux vector
    (`live_aux_len`), and ONE fetch of the (64,) packed output
    (`unpack_live_output`). Returns (rstep, aux length). The scan counter
    rides the aux vector bitwise (an f32 cast would lose integer exactness
    past 2^24 scans). The GICP loops still read their tests on the host
    (ROADMAP, "GICP loop strategy"): one fetch is the output's, not a
    promise that the step never synchronises. `mesh`: serve with the map
    split over its "map" axis (the state sharded by `mesh.shard_state`;
    the big-map live-localization deployment)."""
    _check_mesh(cfg, mesh)
    KI, KO = imu_window, odom_window

    def rstep(state, scan_xyzm, aux):
        seq_id = aux[1:2].view(torch.int32)[0]
        o = 2
        imu_s = aux[o : o + KI]
        o += KI
        imu_q = aux[o : o + KI * 4].reshape(KI, 4)
        o += KI * 4
        odom_s = aux[o : o + KO]
        o += KO
        odom_p = aux[o : o + KO * 16].reshape(KO, 4, 4)
        with shard_context(mesh):
            state, out = replay_step(
                state, scan_xyzm[:, :3], scan_xyzm[:, 3] > 0.5, aux[0], imu_s, imu_q, odom_s, odom_p, seq_id, cfg=cfg
            )
        scalars = torch.stack([getattr(out, k).to(torch.float32) for k in LIVE_SCALARS])
        return state, torch.cat([out.pose.reshape(-1), out.covariance.reshape(-1), scalars])

    return rstep, live_aux_len(KI, KO)


def unpack_live_output(vec) -> pipeline.StepOutput:
    """Host-side inverse of the live step's packed output: a StepOutput of
    numpy values."""
    v = np.asarray(vec)
    s = dict(zip(LIVE_SCALARS, v[52:]))
    return pipeline.StepOutput(
        pose=v[:16].reshape(4, 4),
        covariance=v[16:52].reshape(6, 6),
        condition_number=s["condition_number"],
        prior_source=np.int32(s["prior_source"]),
        scan_to_scan_accepted=bool(s["scan_to_scan_accepted"] > 0.5),
        scan_to_map_accepted=bool(s["scan_to_map_accepted"] > 0.5),
        keyframe_inserted=bool(s["keyframe_inserted"] > 0.5),
        msw_refreshed=bool(s["msw_refreshed"] > 0.5),
        num_points=np.int32(s["num_points"]),
        voxel_leaf=s["voxel_leaf"],
        odom_iterations=np.int32(s["odom_iterations"]),
        loc_iterations=np.int32(s["loc_iterations"]),
        map_size=np.int32(s["map_size"]),
        xy_cross_section=s["xy_cross_section"],
    )


def verification_cloud(scan_xyz, scan_mask, cfg: LocusConfig) -> PointCloud:
    """A keyframe's loop-verification cloud: the raw scan preprocessed at a
    fixed 0.5 m leaf (adaptive leaves vary from scan to scan, and clouds of
    mismatched resolution register badly)."""
    leaf = torch.tensor(0.5, dtype=torch.float32, device=scan_xyz.device)
    return pipeline.preprocess(raw_cloud(scan_xyz, scan_mask), leaf, cfg)


def push_back_closure(state, corrected_pose, corrections, cfg: LocusConfig):
    """The loop-closure push-back into the front end: the integrated
    estimate reset to `corrected_pose` (set_integrated_estimate), the map
    re-anchored by the per-keyframe `corrections` (K,4,4), and the
    keyframe policy's anchor moved to the corrected pose."""
    dev = state.loc.integrated.device
    corrected = torch.as_tensor(corrected_pose, dtype=torch.float32).to(dev)
    corr = torch.as_tensor(corrections, dtype=torch.float32).to(dev)
    return state._replace(
        loc=localization.set_integrated_estimate(state.loc, corrected),
        map=mapper_fabric(cfg.mapper).reanchor(state.map, corr, cfg.mapper),
        last_keyframe_pose=corrected.clone(),
    )


def _summary(out: pipeline.StepOutput) -> dict:
    return {
        "condition_number": float(out.condition_number),
        "prior_source": int(out.prior_source),
        "scan_to_map_accepted": bool(out.scan_to_map_accepted),
        "keyframe_inserted": bool(out.keyframe_inserted),
        "num_points": int(out.num_points),
        "voxel_leaf": float(out.voxel_leaf),
        "map_size": int(out.map_size),
    }


def run_sequence(
    seq: Sequence,
    cfg: Optional[LocusConfig] = None,
    max_scans: Optional[int] = None,
    collect_outputs: bool = True,
    return_state: bool = False,
    backend=None,
    backend_optimize_every: int = 5,
    device=None,
):
    """Replay a sequence on `device` (None: the CUDA device); returns
    (poses (T,4,4) float64, outputs list, RateReport), plus the final
    LocusState when return_state=True. With collect_outputs and
    cfg.b_enable_computation_time_profiling, each scan's latency is
    measured up to a device synchronisation. On the card, where
    `pipeline.capturable(cfg)` holds, every scan replays
    `make_replay_step`'s CUDA graph (the first one also captures it) and
    the report says so (`captured`); elsewhere the eager step runs.

    `backend` (a backend.PoseGraphBackend) runs the online SLAM loop: each
    inserted keyframe is registered with its verification cloud
    (`verification_cloud`), loop closures are tried every
    `backend_optimize_every` keyframes, and after a closure the optimised
    pose and corrections are pushed back (`push_back_closure`; the
    reference's external-backend contract, PointCloudLocalization.h:114-117)."""
    cfg = cfg or LocusConfig()
    dev = resolve_device(device)
    report = RateReport()
    rstep, report.captured = _stepper(cfg, dev)
    state = pipeline.init_state_from_config(
        cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device=dev
    )
    n = len(seq) if max_scans is None else min(max_scans, len(seq))
    device_outs = []
    kf_since_opt = 0
    for i in range(n):
        args = scan_inputs(seq, i, cfg, dev)
        t0 = time.perf_counter()
        state, out = rstep(state, *args)
        out = _kept(out, report.captured)
        if collect_outputs and cfg.b_enable_computation_time_profiling:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            report.add(time.perf_counter() - t0)
        device_outs.append(out)
        if backend is not None and bool(out.keyframe_inserted):
            backend.add_keyframe(float(seq.stamps[i]), out.pose.cpu().numpy(), cloud=verification_cloud(args[0], args[1], cfg))
            kf_since_opt += 1
            if kf_since_opt >= backend_optimize_every:
                kf_since_opt = 0
                if backend.try_close_loops() > 0:
                    backend.optimize()
                    state = push_back_closure(state, backend.correction_for_latest(), backend.corrections_padded(), cfg)
    poses = np.stack([o.pose.cpu().numpy().astype(np.float64) for o in device_outs])
    outputs = [_summary(o) for o in device_outs] if collect_outputs else []
    if return_state:
        return poses, outputs, report, state
    return poses, outputs, report


# The order of `replay_step`'s inputs after the state.
PACKED_KEYS = ("scan_xyz", "scan_mask", "stamps", "imu_s", "imu_q", "odom_s", "odom_p", "seq_ids")


def pack_sequence(seq: Sequence, cfg: LocusConfig, max_scans: Optional[int] = None, device=None):
    """Prepack a whole sequence into fixed-shape device tensors on `device`
    (None: the CUDA device): scan_xyz (T,cap,3), scan_mask (T,cap), stamps
    (T,), imu windows (T,K,...), odom windows (T,Ko,...), seq_ids (T,)."""
    dev = resolve_device(device)
    n = len(seq) if max_scans is None else min(max_scans, len(seq))
    cap = cfg.raw_scan_capacity
    xyzs = np.zeros((n, cap, 3), np.float32)
    masks = np.zeros((n, cap), bool)
    imu_ss, imu_qs, odo_ss, odo_ps = [], [], [], []
    for i in range(n):
        xyzs[i], masks[i] = pack_scan(seq.scans[i], seq.scan_valid[i], cap)
        (imu_s, imu_q), (odom_s, odom_p) = sensor_windows_for_scan(seq, i)
        imu_ss.append(imu_s)
        imu_qs.append(imu_q)
        odo_ss.append(odom_s)
        odo_ps.append(odom_p)
    host = dict(
        scan_xyz=xyzs, scan_mask=masks, stamps=np.asarray(seq.stamps[:n], np.float32),
        imu_s=np.stack(imu_ss), imu_q=np.stack(imu_qs),
        odom_s=np.stack(odo_ss), odom_p=np.stack(odo_ps),
        seq_ids=np.arange(n, dtype=np.int32),
    )
    return {k: torch.as_tensor(v).to(dev) for k, v in host.items()}


def stack_packed(packed_list):
    """Stack per-sequence packed dicts for `make_batched_replay`: tensors
    become (T, B, ...), the scan axis first and the batch axis second."""
    return {k: torch.stack([p[k] for p in packed_list], dim=1) for k in packed_list[0]}


def _replay(cfg: LocusConfig, state, packed, report: Optional[RateReport], outputs: Optional[list] = None,
            rstep=None, captured: bool = False):
    """Step through the T scans of `packed` with `rstep` (default: the eager
    `replay_step`; `captured`: a captured step's, whose outputs are cloned
    before the next replay); returns (state, (poses, condition numbers, map
    sizes)) stacked over the scans. With a report, each scan is timed up
    to a device synchronisation and the report says whether the step ran
    captured; with an `outputs` list, each scan's whole StepOutput is
    appended to it."""
    rstep = rstep or functools.partial(replay_step, cfg=cfg)
    if report is not None:
        report.captured = captured
    poses, conds, sizes = [], [], []
    dev = packed["scan_xyz"].device
    for i in range(packed["scan_xyz"].shape[0]):
        t0 = time.perf_counter()
        state, out = rstep(state, *(packed[k][i] for k in PACKED_KEYS))
        out = _kept(out, captured)
        if report is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            report.add(time.perf_counter() - t0)
        if outputs is not None:
            outputs.append(out)
        poses.append(out.pose)
        conds.append(out.condition_number)
        sizes.append(out.map_size)
    return state, (torch.stack(poses), torch.stack(conds), torch.stack(sizes))


def _check_mesh(cfg: LocusConfig, mesh) -> None:
    """`mesh=` of an entry point: None, or a Mesh over whose map columns the
    configured map tiles into whole chunks (TypeError, ValueError)."""
    if mesh is not None:
        check_mesh(mesh, cfg.mapper.map_capacity)


def _check_sharded(cfg: LocusConfig, mesh, state) -> None:
    """Raise unless the state's map holds this rank's shard."""
    if mesh is not None:
        want = cfg.mapper.map_capacity // mesh.shape["map"]
        if state.map.cloud.capacity != want:
            raise ValueError(
                f"the state's map holds {state.map.cloud.capacity} points, a shard of this mesh {want}: "
                "shard the state with parallel.mesh.shard_state first"
            )


def make_scan_replay(cfg: LocusConfig, mesh=None):
    """The replay of one prepacked sequence (counterpart of the JAX
    `make_scan_replay`): replay(state, packed, report=None, outputs=None)
    -> (state, (poses (T,4,4), cond (T,), map_sizes (T,))). It is the
    reference the batched replay is held against. The JAX `unroll` is a
    `lax.scan` notion with no counterpart. On the card, where
    `pipeline.capturable(cfg, mesh)` holds, every scan is a replay of one
    CUDA graph (`make_replay_step`, captured at the first call and kept
    for every later one); elsewhere the eager step. The report says which
    (`captured`). The returned state is the graph's static state, which
    the next call of this replay overwrites.

    `mesh`: one sequence with its map split over the mesh's "map" axis
    (the big-map deployment); every rank calls the replay with the same
    packed scans and its shard of the state (`mesh.shard_state`), and
    gets the same poses and whole-map sizes."""
    _check_mesh(cfg, mesh)
    steppers = {}   # by device: one captured graph for every call on the card

    def replay(state, packed, report: Optional[RateReport] = None, outputs: Optional[list] = None):
        _check_sharded(cfg, mesh, state)
        dev = packed["scan_xyz"].device
        if dev not in steppers:
            steppers[dev] = _stepper(cfg, dev, mesh)
        rstep, captured = steppers[dev]
        with shard_context(mesh):
            return _replay(cfg, state, packed, report, outputs, rstep, captured)

    return replay


def make_batched_replay(cfg: LocusConfig, mesh=None, use_pallas: Optional[bool] = None):
    """Multi-sequence batch replay (counterpart of the JAX
    `make_batched_replay`, a vmap of the scan replay): replay(states,
    packed, report=None, outputs=None) -> (states, (poses (T,B,4,4), cond
    (T,B), map_sizes (T,B))) on states stacked by `pipeline.stack_states`
    and inputs stacked by `stack_packed`, in every single-card
    configuration of the step. One batched step per tick: every op and
    kernel launch serves all B robots (kernels B3, and B4 where the step
    runs radius normals), and each robot equals its own `make_scan_replay`
    bit for bit.

    On the card, where `pipeline.capturable(cfg, mesh)` holds, every tick
    is a replay of one CUDA graph (`make_replay_step` on the stacked
    state, named `BATCHED_REPLAY_STEP`, captured at the first call and
    kept for every later one): the GICP trips and re-lookups are IF nodes
    on "some member still iterates", and no tick reads the device on the
    host. Elsewhere (`use_pallas=False`, an uncapturable configuration,
    the CPU, `mesh`) the eager step runs. The report says which
    (`captured`); the returned state is then the graph's static state,
    which the next call of this replay overwrites. Each call is one
    `record_function` span, "runner.batched_replay".

    `use_pallas=False` runs the kernels' plain PyTorch versions
    (`dispatch.no_kernels()`, the ablation); None and True run the kernels
    on the card. The JAX `unroll` is a `lax.scan` notion with no
    counterpart. With a report, each tick is timed up to a device
    synchronisation.

    `mesh`: the batch split over the mesh's "data" rows and each robot's
    map over its "map" columns. Every rank passes its own data row's
    robots (`distributed.local_batch_slice`: their states, each map cut to
    this rank's shard by `mesh.shard_state`, and their packed scans) and
    gets their poses; the loops run while any of those robots iterates,
    the same on every rank of the row."""
    _check_mesh(cfg, mesh)
    steppers = {}   # by device: one captured graph for every call on the card

    def replay(states, packed, report: Optional[RateReport] = None, outputs: Optional[list] = None):
        _check_sharded(cfg, mesh, states)
        dev = packed["scan_xyz"].device
        if use_pallas is False:
            rstep, captured, ctx = None, False, no_kernels()
        else:
            if dev not in steppers:
                steppers[dev] = _stepper(cfg, dev, mesh, BATCHED_REPLAY_STEP)
            (rstep, captured), ctx = steppers[dev], contextlib.nullcontext()
        with ctx, shard_context(mesh), record_function("runner.batched_replay"):
            return _replay(cfg, states, packed, report, outputs, rstep, captured)

    return replay
