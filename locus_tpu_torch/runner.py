"""Host-side replay runner (counterpart of `locus_tpu/runner.py`): per
scan it packs the raw scan to a fixed shape, pushes the sensor windows
into the device-resident fusion buffers and runs one pipeline step, then
collects the trajectory and diagnostics on the host.

This slice ports `pack_scan`, the replay step and `run_sequence` without
the SLAM backend (ROADMAP A14); batched and scanned replays are A15.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from locus_tpu_torch import fusion, pipeline
from locus_tpu_torch.config import LocusConfig
from locus_tpu_torch.core.cloud import PAD_COORD, PointCloud
from locus_tpu_torch.io.dataset import Sequence, sensor_windows_for_scan
from locus_tpu_torch.metrics import RateReport
from locus_tpu_torch.ops.dispatch import resolve_device


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


def replay_step(state, scan_xyz, scan_mask, stamp, imu_s, imu_q, odom_s, odom_p, seq_id, cfg: LocusConfig):
    """Sensor ingest + one pipeline step (counterpart of the function
    `locus_tpu/runner.py::make_replay_step` compiles)."""
    fuse = fusion.push_imu_batch(state.fuse, imu_s, imu_q)
    fuse = fusion.push_odom_batch(fuse, odom_s, odom_p)
    state = state._replace(fuse=fuse)
    raw = PointCloud(
        torch.where(scan_mask[:, None], scan_xyz, PAD_COORD),
        torch.zeros_like(scan_xyz),
        torch.zeros(scan_xyz.shape[0], dtype=torch.float32, device=scan_xyz.device),
        scan_mask,
    )
    return pipeline.step(state, raw, stamp, cfg, seq=seq_id)


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
    device=None,
):
    """Replay a sequence on `device` (None: the CUDA device); returns
    (poses (T,4,4) float64, outputs list, RateReport), plus the final
    LocusState when return_state=True. With collect_outputs and
    cfg.b_enable_computation_time_profiling, each scan's latency is
    measured up to a device synchronisation."""
    cfg = cfg or LocusConfig()
    dev = resolve_device(device)
    state = pipeline.init_state_from_config(
        cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device=dev
    )
    n = len(seq) if max_scans is None else min(max_scans, len(seq))
    report = RateReport()
    device_outs = []
    for i in range(n):
        args = scan_inputs(seq, i, cfg, dev)
        t0 = time.perf_counter()
        state, out = replay_step(state, *args, cfg=cfg)
        if collect_outputs and cfg.b_enable_computation_time_profiling:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            report.add(time.perf_counter() - t0)
        device_outs.append(out)
    poses = np.stack([o.pose.cpu().numpy().astype(np.float64) for o in device_outs])
    outputs = [_summary(o) for o in device_outs] if collect_outputs else []
    if return_state:
        return poses, outputs, report, state
    return poses, outputs, report
