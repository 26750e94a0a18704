"""Sensor-prior fusion: IMU / wheel-odometry ring buffers, the health
cascade and per-scan prior selection (counterpart of
`locus_tpu/fusion.py`; reference Locus.cc:853-1042).

Buffers are fixed-size device tensors, one packed row per sample; a slot
is valid iff its stamp is finite. All selection logic is branch-free
tensor code, so it runs on the device without host reads. Every function
but the single-sample pushes (`push_imu`, `push_odom`) also takes a state
with one leading batch dimension (the batched replay: each robot its own
buffers, pointers and lookups).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from locus_tpu_torch.config import FusionConfig
from locus_tpu_torch.core.cloud import take_rows
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.ops.dispatch import resolve_device

# Prior source codes (diagnostics)
PRIOR_NONE = 0
PRIOR_IMU = 1
PRIOR_IMU_YAW = 2
PRIOR_ODOM = 3


class ImuBuffer(NamedTuple):
    """(B,5) rows [stamp, qw, qx, qy, qz]; empty slots carry stamp -inf."""

    data: torch.Tensor
    ptr: torch.Tensor             # int32 ring pointer
    last_reception: torch.Tensor  # f32 stamp of the last insert

    @property
    def stamps(self) -> torch.Tensor:
        return self.data[..., 0]

    @property
    def quats(self) -> torch.Tensor:
        return self.data[..., 1:5]

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.data[..., 0])


class OdomBuffer(NamedTuple):
    """(B,13) rows [stamp, R.flatten(9), t(3)]."""

    data: torch.Tensor
    ptr: torch.Tensor
    last_reception: torch.Tensor

    @property
    def stamps(self) -> torch.Tensor:
        return self.data[..., 0]

    @property
    def poses(self) -> torch.Tensor:
        return _unpack_pose_row(self.data)

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.data[..., 0])


def _pack_pose_rows(stamps: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """(...,K), (...,K,4,4) -> (...,K,13) packed rows."""
    return torch.cat([stamps[..., None], poses[..., :3, :3].flatten(-2), poses[..., :3, 3]], dim=-1)


def _unpack_pose_row(row: torch.Tensor) -> torch.Tensor:
    """(...,13) packed rows -> (...,4,4) poses."""
    return se3.make_transform(row[..., 1:10].unflatten(-1, (3, 3)), row[..., 10:13])


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Entry i (...) of each member's buffer x (...,size) or (...,size,C):
    x[i] on the single path."""
    out = take_rows(x, i[..., None])
    return out[..., 0] if x.dim() == i.dim() + 1 else out[..., 0, :]


class FusionState(NamedTuple):
    imu: ImuBuffer
    odom: OdomBuffer
    imu_quat_prev: torch.Tensor      # (4,)
    imu_received: torch.Tensor       # bool
    odom_pose_prev: torch.Tensor     # (4,4)
    odom_received: torch.Tensor      # bool


class PriorSelection(NamedTuple):
    prior: torch.Tensor       # (4,4) motion prior for the GICP warm start
    source: torch.Tensor      # int32 PRIOR_* code
    pure_lo: torch.Tensor     # bool — no usable sensor
    state: FusionState


def init_state(cfg: FusionConfig, device=None) -> FusionState:
    """Empty buffers on `device` (None: the CUDA device)."""
    device = resolve_device(device)
    bi, bo = cfg.imu_buffer_size, cfg.odometry_buffer_size
    f32 = dict(dtype=torch.float32, device=device)
    neg_inf = torch.tensor(float("-inf"), **f32)
    imu_rows = torch.cat(
        [torch.full((bi, 1), float("-inf"), **f32),
         torch.tensor([[1.0, 0.0, 0.0, 0.0]], **f32).repeat(bi, 1)],
        dim=1,
    )
    odom_rows = _pack_pose_rows(
        torch.full((bo,), float("-inf"), **f32), torch.eye(4, **f32).repeat(bo, 1, 1)
    )
    zero = torch.tensor(0, dtype=torch.int32, device=device)
    return FusionState(
        imu=ImuBuffer(data=imu_rows, ptr=zero.clone(), last_reception=neg_inf.clone()),
        odom=OdomBuffer(data=odom_rows, ptr=zero.clone(), last_reception=neg_inf.clone()),
        imu_quat_prev=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32),
        imu_received=torch.tensor(False, device=device),
        odom_pose_prev=torch.eye(4, **f32),
        odom_received=torch.tensor(False, device=device),
    )


# ---------------------------------------------------------------------------
# Ingestion (ImuCallback / OdometryCallback equivalents)
# ---------------------------------------------------------------------------

def _ring_put(buf, row: torch.Tensor, ok: torch.Tensor, wall: torch.Tensor):
    """Write one packed row at the ring pointer when `ok` holds; the
    reception stamp becomes `wall`."""
    i = (buf.ptr.to(torch.int64) % buf.data.shape[0]).reshape(1)
    data = buf.data.index_put((i,), row[None])
    return type(buf)(
        torch.where(ok, data, buf.data),
        torch.where(ok, buf.ptr + 1, buf.ptr),
        torch.where(ok, wall, buf.last_reception),
    )


def _sample_stamps(buf, stamp, wall_time):
    dev = buf.data.device
    s = torch.as_tensor(stamp, dtype=torch.float32, device=dev).reshape(1)
    wall = s[0] if wall_time is None else torch.as_tensor(wall_time, dtype=torch.float32, device=dev)
    return s, wall


def push_imu(state: FusionState, stamp, quat_wxyz, wall_time=None) -> FusionState:
    """Insert one IMU orientation sample (Locus.cc:356-372); `wall_time`
    (default: the stamp) is its reception time for the health check. NaN
    samples are dropped (CheckNans, Locus.cc:733-743)."""
    b = state.imu
    s, wall = _sample_stamps(b, stamp, wall_time)
    quat = torch.as_tensor(quat_wxyz, dtype=torch.float32, device=b.data.device)
    ok = ~torch.any(torch.isnan(quat))
    return state._replace(imu=_ring_put(b, torch.cat([s, quat]), ok, wall))


def push_odom(state: FusionState, stamp, pose_4x4, wall_time=None) -> FusionState:
    """Insert one odometry pose sample (Locus.cc:374-399); NaN samples are
    dropped."""
    b = state.odom
    s, wall = _sample_stamps(b, stamp, wall_time)
    pose = torch.as_tensor(pose_4x4, dtype=torch.float32, device=b.data.device)
    ok = ~torch.any(torch.isnan(pose))
    return state._replace(odom=_ring_put(b, _pack_pose_rows(s, pose[None])[0], ok, wall))


def _ring_append(data, ptr, last_reception, stamps, rows, ok):
    """Append the rows where `ok` holds, in order, at the ring pointer;
    the others are dropped (written to a scratch row that is cut off)."""
    size = data.shape[-2]
    offs = torch.cumsum(ok.to(torch.int64), -1) - 1
    idx = torch.where(ok, (ptr.to(torch.int64)[..., None] + offs) % size, size)
    ext = torch.cat([data, data.new_zeros(data.shape[:-2] + (1, data.shape[-1]))], dim=-2)
    new_data = ext.scatter(-2, idx[..., None].expand(rows.shape), rows)[..., :size, :]
    new_ptr = ptr + torch.sum(ok, dim=-1, dtype=torch.int32)
    latest = torch.amax(torch.where(ok, stamps, float("-inf")), dim=-1)
    return new_data, new_ptr, torch.maximum(last_reception, latest)


def push_imu_batch(state: FusionState, stamps, quats) -> FusionState:
    """Ingest a (...,K) stamp + (...,K,4) quat window; -inf stamps are
    padding."""
    dev = state.imu.data.device
    stamps = torch.as_tensor(stamps, dtype=torch.float32, device=dev)
    quats = torch.as_tensor(quats, dtype=torch.float32, device=dev)
    ok = torch.isfinite(stamps) & ~torch.any(torch.isnan(quats), dim=-1)
    rows = torch.cat([stamps[..., None], quats], dim=-1)
    b = state.imu
    return state._replace(imu=ImuBuffer(*_ring_append(b.data, b.ptr, b.last_reception, stamps, rows, ok)))


def push_odom_batch(state: FusionState, stamps, poses) -> FusionState:
    """Ingest a (...,K) stamp + (...,K,4,4) pose window; -inf stamps are
    padding."""
    dev = state.odom.data.device
    stamps = torch.as_tensor(stamps, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    ok = torch.isfinite(stamps) & ~torch.any(torch.isnan(poses).flatten(-2), dim=-1)
    rows = _pack_pose_rows(stamps, poses)
    b = state.odom
    return state._replace(odom=OdomBuffer(*_ring_append(b.data, b.ptr, b.last_reception, stamps, rows, ok)))


# ---------------------------------------------------------------------------
# Lookup + health
# ---------------------------------------------------------------------------

def _nearest_in_buffer(stamps, valid, stamp, max_staleness):
    """GetMsgAtTime (Locus.cc:853-887): nearest-timestamp entry, rejected
    when farther than max_staleness. Returns (index, found)."""
    diff = torch.where(valid, torch.abs(stamps - stamp[..., None]), float("inf"))
    i = torch.argmin(diff, dim=-1)
    return i, _at(diff, i) <= max_staleness


def is_odom_healthy(state: FusionState, now, cfg: FusionConfig):
    return (now - state.odom.last_reception) < cfg.sensor_health_timeout


def is_imu_healthy(state: FusionState, now, cfg: FusionConfig):
    return (now - state.imu.last_reception) < cfg.sensor_health_timeout


def odom_pose_at(buf: OdomBuffer, t):
    """Time-interpolated odometry pose at t (IntegrateInterpolatedOdom,
    Locus.cc:949-1015): slerp rotation / lerp translation between the
    bracketing samples. Returns (pose (4,4), ok)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=buf.data.device)
    stamps = torch.where(buf.valid, buf.stamps, float("-inf"))
    before = torch.where(stamps <= t[..., None], stamps, float("-inf"))
    i0 = torch.argmax(before, dim=-1)
    after = torch.where(stamps >= t[..., None], stamps, float("inf"))
    i1 = torch.argmin(after, dim=-1)
    have_any = torch.any(buf.valid, dim=-1)
    # extrapolation: fall back to the nearest available sample
    i0 = torch.where(torch.isfinite(_at(before, i0)), i0, i1)
    i1 = torch.where(torch.isfinite(_at(after, i1)), i1, i0)
    t0, t1 = _at(stamps, i0), _at(stamps, i1)
    alpha = torch.where(t1 > t0, (t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0)
    alpha = torch.clamp(alpha, 0.0, 1.0)[..., None]
    P0, P1 = _unpack_pose_row(_at(buf.data, i0)), _unpack_pose_row(_at(buf.data, i1))
    q = se3.quat_slerp(
        se3.matrix_to_quat(se3.rotation(P0)), se3.matrix_to_quat(se3.rotation(P1)), alpha
    )
    trans = (1.0 - alpha) * se3.translation(P0) + alpha * se3.translation(P1)
    return se3.make_transform(se3.quat_to_matrix(q), trans), have_any


def integrate_interpolated_odom(state: FusionState, prev_stamp, stamp):
    """Delta of the interpolated odometry between the previous and current
    scan stamps; identity when unavailable. Returns (delta (4,4), ok)."""
    P_prev, ok0 = odom_pose_at(state.odom, prev_stamp)
    P_cur, ok1 = odom_pose_at(state.odom, stamp)
    ok = ok0 & ok1 & (prev_stamp >= 0)
    delta = se3.pose_delta(P_prev, P_cur)
    return torch.where(ok[..., None, None], delta, se3.identity(delta.device)), ok


# ---------------------------------------------------------------------------
# Prior integration (the cascade)
# ---------------------------------------------------------------------------

def integrate_sensors(state: FusionState, stamp, now, cfg: FusionConfig, prev_stamp=None) -> PriorSelection:
    """IntegrateSensors (Locus.cc:904-924): odom if healthy and mode >= 3,
    else IMU if healthy and mode >= 1 (yaw-only for mode 2), else
    lidar-only with an identity prior.

    As in the JAX package: the branch choice depends on health only; the
    delta anchor is dropped only when the cascade takes another branch and
    survives a lookup miss; a re-anchor or lookup-miss scan is processed
    prior-free (identity, PRIOR_NONE) where the reference drops it."""
    mode = cfg.data_integration_mode
    dev = state.odom.data.device
    identity = se3.identity(dev)
    stamp, now = (torch.as_tensor(t, dtype=torch.float32, device=dev) for t in (stamp, now))
    if prev_stamp is not None:
        prev_stamp = torch.as_tensor(prev_stamp, dtype=torch.float32, device=dev)

    choose_odom = is_odom_healthy(state, now, cfg) & (mode >= 3)
    choose_imu = (~choose_odom) & is_imu_healthy(state, now, cfg) & (mode >= 1)

    oi, o_found = _nearest_in_buffer(state.odom.stamps, state.odom.valid, stamp, cfg.max_buffer_staleness)
    odom_pose = _unpack_pose_row(_at(state.odom.data, oi))
    if cfg.b_integrate_interpolated_odom and prev_stamp is not None:
        odom_delta, _ = integrate_interpolated_odom(state, prev_stamp, stamp)
        o_found = torch.ones_like(o_found)
        store_prev = torch.zeros_like(o_found)
    else:
        odom_delta = se3.pose_delta(state.odom_pose_prev, odom_pose)
        store_prev = choose_odom & o_found
    use_odom = choose_odom & o_found & state.odom_received

    ii, i_found = _nearest_in_buffer(state.imu.stamps, state.imu.valid, stamp, cfg.max_buffer_staleness)
    imu_quat = _at(state.imu.data, ii)[..., 1:5]
    dq = se3.quat_multiply(se3.quat_conjugate(state.imu_quat_prev), imu_quat)
    if cfg.b_convert_imu_to_base_link_frame:
        # dq_base = q_bi . dq_imu . q_bi^-1 (IntegrateImu, Locus.cc:1017-1042)
        q_bi = torch.tensor(cfg.imu_to_base_quat, dtype=torch.float32, device=dev)
        dq = se3.quat_multiply(se3.quat_multiply(q_bi, dq), se3.quat_conjugate(q_bi))
    R_full = se3.quat_to_matrix(dq)
    R_imu = se3.yaw_only_matrix(R_full) if mode == 2 else R_full
    imu_prior = se3.make_transform(R_imu, torch.zeros(R_imu.shape[:-2] + (3,), device=dev))
    use_imu = choose_imu & i_found & state.imu_received

    prior = torch.where(
        use_odom[..., None, None],
        se3.make_transform(se3.rotation(odom_delta), se3.translation(odom_delta)),
        torch.where(use_imu[..., None, None], imu_prior, identity),
    )
    imu_code = PRIOR_IMU_YAW if mode == 2 else PRIOR_IMU
    source = torch.where(
        use_odom,
        torch.tensor(PRIOR_ODOM, dtype=torch.int32, device=dev),
        torch.where(
            use_imu,
            torch.tensor(imu_code, dtype=torch.int32, device=dev),
            torch.tensor(PRIOR_NONE, dtype=torch.int32, device=dev),
        ),
    )
    new_state = state._replace(
        odom_pose_prev=torch.where(store_prev[..., None, None], odom_pose, state.odom_pose_prev),
        odom_received=torch.where(choose_odom, state.odom_received | o_found, False),
        imu_quat_prev=torch.where((choose_imu & i_found)[..., None], imu_quat, state.imu_quat_prev),
        imu_received=torch.where(choose_imu, state.imu_received | i_found, False),
    )
    return PriorSelection(prior=prior, source=source, pure_lo=~(use_odom | use_imu), state=new_state)
