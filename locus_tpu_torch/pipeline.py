"""The LOCUS pipeline orchestrator: one step per lidar sweep (counterpart
of `locus_tpu/pipeline.py`; reference Locus.cc:425-561).

    preprocess (crop + voxel + normals)      [kernel B1 in the normals]
    -> prior selection cascade               [IntegrateSensors]
    -> scan-to-scan GICP                     [kernel B2 at SCAN_BT]
    -> map 1-NN -> scan-to-submap GICP       [kernel B2 at BT, then SCAN_BT]
    -> covariance / observability
    -> keyframe insert + MSW refresh         [masked passes]

plus the adaptive input-voxelization feedback, the keyframe policy with
open/closed-space thresholds, and the velocity-gated MSW refresh.

Every single-card configuration of the JAX step is ported: GICP or NDT
in either stage, the ring or the voxel-hash map, radius or kNN normals,
the LOAM feature path, the grid/random/outlier/radius filters, keyframes
at map resolution, the in-graph space monitor and the ground-truth-map
bootstrap. The sharded map raises NotImplementedError (ROADMAP A16).

Batching: `step` also advances B robots at once, on states stacked by
`stack_states` (every leaf with a leading B) and per-robot inputs; it has
the meaning the JAX package gives a vmap of its `step`. Each robot
keeps its own pose, map, fusion buffers and adaptive leaf. No Python loop
runs over the robots: every op and kernel launch serves all of them (the
normals run kernel B4, the 1-NN passes kernel B3). The batched step runs
the default configuration (GICP, ring map, radius normals, no optional
filter); the other options raise NotImplementedError (ROADMAP A15b).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from locus_tpu_torch import fusion, localization, odometry
from locus_tpu_torch.config import LocusConfig
from locus_tpu_torch.core.cloud import PointCloud, concatenate
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.mapping.registry import mapper_fabric
from locus_tpu_torch.ops import features as feat, filters, normals as normals_op, voxel
from locus_tpu_torch.ops.dispatch import resolve_device


class Stats(NamedTuple):
    scan_count: torch.Tensor            # int32
    keyframe_count: torch.Tensor        # int32
    rejected_scan_to_scan: torch.Tensor
    rejected_scan_to_map: torch.Tensor
    dropped_msgs: torch.Tensor          # seq-gap statistics (CheckMsgDropRate)
    last_seq: torch.Tensor


class VelocityBuffer(NamedTuple):
    trans: torch.Tensor   # (V,) recent translational velocities
    rot: torch.Tensor     # (V,) recent rotational velocities
    ptr: torch.Tensor


class LocusState(NamedTuple):
    odom: odometry.OdometryState
    loc: localization.LocalizationState
    map: object                         # the cfg.mapper.structure's MapState
    fuse: fusion.FusionState
    voxel_leaf: torch.Tensor            # runtime-adaptive leaf size
    last_keyframe_pose: torch.Tensor    # (4,4)
    previous_stamp: torch.Tensor        # f32 seconds
    velocities: VelocityBuffer
    open_space: torch.Tensor            # bool (localizer space monitor)
    stats: Stats


class StepOutput(NamedTuple):
    pose: torch.Tensor                  # (4,4) integrated world pose
    covariance: torch.Tensor            # (6,6)
    condition_number: torch.Tensor
    prior_source: torch.Tensor          # fusion.PRIOR_*
    scan_to_scan_accepted: torch.Tensor
    scan_to_map_accepted: torch.Tensor
    keyframe_inserted: torch.Tensor
    msw_refreshed: torch.Tensor
    num_points: torch.Tensor            # valid points after preprocessing
    voxel_leaf: torch.Tensor
    odom_iterations: torch.Tensor
    loc_iterations: torch.Tensor
    map_size: torch.Tensor
    xy_cross_section: torch.Tensor      # -1: the in-graph space monitor is off


def _check_supported(cfg: LocusConfig) -> None:
    if cfg.mapper.num_shards != 1:
        raise NotImplementedError("sharded map: ROADMAP A16")


def _check_batched_supported(cfg: LocusConfig) -> None:
    """The batched step runs the default configuration only."""
    f = cfg.filtering
    stages = (cfg.odometry, cfg.localization.registration)
    unported = [
        (any(r.registration_method != "gicp" for r in stages), "NDT"),
        (any(r.covariance_mode != "normals" or r.recompute_covariances for r in stages),
         "GICP recompute/adaptive covariances"),
        (f.extract_features, "LOAM feature extraction"),
        (f.grid_filter or f.random_filter or f.outlier_filter or f.radius_filter,
         "grid/random/outlier/radius filters"),
        (f.normals_method != "radius", "kNN normals"),
        (cfg.mapper.structure != "ring", "the voxel-hash map"),
        (cfg.mapper.keyframe_at_map_resolution, "keyframe_at_map_resolution"),
        (cfg.b_monitor_space, "the in-graph space monitor"),
        (cfg.b_run_with_gt_point_cloud, "the ground-truth-map bootstrap"),
    ]
    for cond, what in unported:
        if cond:
            raise NotImplementedError(f"batched step with {what}: ROADMAP A15b")


def init_state(cfg: LocusConfig, initial_pose: Optional[torch.Tensor] = None, device=None) -> LocusState:
    """Initial pipeline state on `device` (None: the CUDA device)."""
    dev = resolve_device(device)
    _check_supported(cfg)
    if initial_pose is not None:
        initial_pose = torch.as_tensor(initial_pose, dtype=torch.float32).to(dev)
    v = cfg.mapper.velocity_buffer_size
    i32 = dict(dtype=torch.int32, device=dev)
    zero = torch.tensor(0, **i32)
    return LocusState(
        odom=odometry.init_state(cfg.scan_capacity, initial_pose, device=dev),
        loc=localization.init_state(initial_pose, device=dev),
        map=mapper_fabric(cfg.mapper).init_map(cfg.mapper, device=dev),
        fuse=fusion.init_state(cfg.fusion, device=dev),
        voxel_leaf=torch.tensor(cfg.filtering.grid_res, dtype=torch.float32, device=dev),
        last_keyframe_pose=(
            initial_pose.clone() if initial_pose is not None else se3.identity(dev)
        ),
        previous_stamp=torch.tensor(-1.0, dtype=torch.float32, device=dev),
        velocities=VelocityBuffer(
            trans=torch.zeros((v,), dtype=torch.float32, device=dev),
            rot=torch.zeros((v,), dtype=torch.float32, device=dev),
            ptr=zero.clone(),
        ),
        open_space=torch.tensor(False, device=dev),
        stats=Stats(
            scan_count=zero.clone(),
            keyframe_count=zero.clone(),
            rejected_scan_to_scan=zero.clone(),
            rejected_scan_to_map=zero.clone(),
            dropped_msgs=zero.clone(),
            last_seq=torch.tensor(-1, **i32),
        ),
    )


def _map_tree(fn, *trees):
    """Apply `fn` leafwise over (Named)tuples of tensors of one structure."""
    head = trees[0]
    if isinstance(head, tuple):
        parts = [_map_tree(fn, *p) for p in zip(*trees)]
        return type(head)(*parts) if hasattr(head, "_fields") else tuple(parts)
    return fn(*trees)


def stack_states(states) -> LocusState:
    """Stack B single states into one batched state (every leaf gets a
    leading B), the input of the batched `step`."""
    return _map_tree(lambda *xs: torch.stack(xs), *states)


def member(state, b: int):
    """Robot b's single state (or output) out of a batched one."""
    return _map_tree(lambda x: x[b], state)


def init_states(
    cfg: LocusConfig, initial_poses=None, num_robots: Optional[int] = None, device=None
) -> LocusState:
    """Batched initial state of B robots on `device` (None: the CUDA
    device): `init_state_from_config` per robot, stacked. `initial_poses`
    (B,4,4) or None (then `num_robots` of them at the configured pose)."""
    dev = resolve_device(device)
    _check_batched_supported(cfg)
    if initial_poses is None:
        poses = [None] * num_robots
    else:
        poses = [torch.as_tensor(p, dtype=torch.float32) for p in initial_poses]
    return stack_states([init_state_from_config(cfg, p, device=dev) for p in poses])


def init_with_gt_map(
    cfg: LocusConfig, map_xyz, map_normals=None, initial_pose: Optional[torch.Tensor] = None, device=None
) -> LocusState:
    """Ground-truth-map bootstrap (InitWithGTPointCloud, Locus.cc:745-758):
    the map store pre-filled from a prior map (e.g. a PCD through
    `io.pcd`), its normals estimated by kNN when not given. Pair with
    cfg.b_add_keyframes_enabled=False for pure localization."""
    import numpy as np

    from locus_tpu_torch.ops.kernels.nn import build_nn_target, chunk_boxes

    dev = resolve_device(device)
    state = init_state(cfg, initial_pose, device=dev)
    cap = cfg.mapper.map_capacity
    pc = PointCloud.from_points(
        np.asarray(map_xyz, np.float32)[:cap], capacity=cap, device=dev,
        normals=None if map_normals is None else np.asarray(map_normals, np.float32)[:cap],
    )
    if map_normals is None:
        pc = normals_op.estimate_normals(pc, k=cfg.filtering.normals_k)
    nn_aug = build_nn_target(pc.xyz)
    c_min, c_max = chunk_boxes(pc.xyz, pc.mask, nn_aug.shape[0])
    one = torch.tensor(1, dtype=torch.int32, device=dev)
    if cfg.mapper.structure == "voxel_hash":
        new_map = state.map._replace(
            cloud=pc, keys=torch.floor(pc.xyz / cfg.mapper.map_voxel_leaf).to(torch.int32),
            occupied=pc.mask, num_keyframes=one, nn_aug=nn_aug, chunk_min=c_min, chunk_max=c_max,
        )
    else:
        new_map = state.map._replace(
            cloud=pc, write_ptr=pc.count() % cap, num_keyframes=one,
            nn_aug=nn_aug, chunk_min=c_min, chunk_max=c_max,
        )
    return state._replace(map=new_map)


def init_state_from_config(
    cfg: LocusConfig, initial_pose: Optional[torch.Tensor] = None, device=None
) -> LocusState:
    """Config-driven init: the fiducial initial pose when configured
    (PointCloudOdometry.cc:50-70), and with b_run_with_gt_point_cloud the
    map bootstrapped from gt_point_cloud_filename (Locus.cc:745-758)."""
    dev = resolve_device(device)
    if initial_pose is None and cfg.fiducial_position is not None:
        q = torch.tensor(cfg.fiducial_orientation_wxyz or (1.0, 0.0, 0.0, 0.0), dtype=torch.float32, device=dev)
        initial_pose = se3.make_transform(
            se3.quat_to_matrix(q), torch.tensor(cfg.fiducial_position, dtype=torch.float32, device=dev)
        )
    if cfg.b_run_with_gt_point_cloud:
        if not cfg.gt_point_cloud_filename:
            raise ValueError("b_run_with_gt_point_cloud requires gt_point_cloud_filename")
        from locus_tpu_torch.io import pcd

        xyz, normals = pcd.read_pcd_xyz_normals(cfg.gt_point_cloud_filename)
        return init_with_gt_map(cfg, xyz, normals, initial_pose, device=dev)
    return init_state(cfg, initial_pose, device=dev)


def set_open_space(state: LocusState, open_space) -> LocusState:
    """Localizer-space-monitor hook (Locus.cc:316-319, 571-576): switch the
    keyframe thresholds between the open- and closed-space profiles."""
    return state._replace(open_space=torch.as_tensor(open_space, dtype=torch.bool).to(state.open_space.device))


def preprocess(raw: PointCloud, leaf, cfg: LocusConfig, generator: Optional[torch.Generator] = None,
               open_space=None) -> PointCloud:
    """body crop -> voxel grid at the runtime leaf -> the optional filters
    -> normals; or, with extract_features, body crop -> LOAM features ->
    kNN normals. A scan at cfg.scan_capacity.

    `generator` seeds the random filter (`step` makes one from the scan
    count); `open_space` (bool tensor) picks its open-space percentage."""
    f = cfg.filtering
    pc = raw
    if f.body_filter:
        pc = filters.crop_box(pc, f.box_min, f.box_max, negative=True)
    if f.extract_features:
        # Features come from the crop-filtered raw scan (the range image
        # needs the sweep's dense azimuth bins), the bulk of LESS_FLAT
        # cells is thinned by a voxel grid at grid_res, and normals are
        # kNN (the leaf-derived radius means nothing here).
        fg = feat.extract_features(pc, width=f.feature_width)
        edge, planar = feat.feature_clouds(
            fg, edge_capacity=cfg.scan_capacity // 4, planar_capacity=feat.RINGS * f.feature_width
        )
        planar = voxel.voxel_downsample(
            planar, torch.tensor(f.grid_res, dtype=torch.float32, device=pc.xyz.device),
            capacity=cfg.scan_capacity - cfg.scan_capacity // 4,
        )
        pc = concatenate([edge, planar], capacity=cfg.scan_capacity)
        return normals_op.estimate_normals(pc, k=f.normals_k)
    # the raw scan carries no normals or intensity yet
    pc = voxel.voxel_downsample(pc, leaf, capacity=cfg.scan_capacity, with_attributes=False)
    if f.grid_filter:
        # PointCloudFilter's own fixed-leaf grid (PointCloudFilter.cc:119-130)
        pc = voxel.voxel_downsample(
            pc, torch.tensor(f.grid_res, dtype=torch.float32, device=pc.xyz.device),
            capacity=cfg.scan_capacity, with_attributes=False,
        )
    if f.random_filter and generator is not None:
        pct = torch.tensor(f.decimate_percentage, dtype=torch.float32, device=pc.xyz.device)
        if open_space is not None:
            pct = torch.where(open_space, f.decimate_percentage_open_space, pct)
        pc = filters.random_sample(pc, generator, pct)
    if f.outlier_filter:
        pc = filters.statistical_outlier(pc, f.outlier_knn, f.outlier_std)
    if f.radius_filter:
        pc = filters.radius_outlier(pc, f.radius, f.radius_knn)
    if f.normals_method == "radius":
        return normals_op.estimate_normals_radius(pc, radius=f.normals_radius_scale * leaf)
    return normals_op.estimate_normals(pc, k=f.normals_k)


def _random_filter_generator(scan_count: torch.Tensor) -> torch.Generator:
    """The random filter's generator, seeded from the scan count: one draw
    per scan index, whatever the layout (the JAX package folds the count
    into a PRNG key). A CPU generator, so the CPU and the card draw alike;
    reading the count is one host read per scan."""
    g = torch.Generator()
    g.manual_seed(int(scan_count))
    return g


def _space_monitor(scan: PointCloud, cfg: LocusConfig):
    """In-graph localizer space monitor: the xy cross-section of the
    scan's lateral bounding box near the sensor plane (|z| < 1 m) ->
    (open_space, the area or -1 when b_publish_xy_cross_section is off)."""
    near_plane = scan.mask & (torch.abs(scan.xyz[:, 2]) < 1.0)
    big = 1e9
    x = torch.where(near_plane, scan.xyz[:, 0], big)
    y = torch.where(near_plane, scan.xyz[:, 1], big)
    xs = torch.where(near_plane, scan.xyz[:, 0], -big)
    ys = torch.where(near_plane, scan.xyz[:, 1], -big)
    area = torch.clamp(torch.amax(xs) - torch.amin(x), min=0.0) * torch.clamp(torch.amax(ys) - torch.amin(y), min=0.0)
    shown = area if cfg.b_publish_xy_cross_section else torch.full_like(area, -1.0)
    return area > cfg.xy_cross_section_threshold, shown


def step(
    state: LocusState,
    raw_scan: PointCloud,
    stamp: torch.Tensor,
    cfg: LocusConfig,
    seq: Optional[torch.Tensor] = None,
) -> tuple[LocusState, StepOutput]:
    """Process one merged sweep (base frame); batched, one sweep per robot
    (`raw_scan` (B, N), `stamp` and `seq` (B,))."""
    _check_supported(cfg)
    if raw_scan.mask.dim() > 1:
        _check_batched_supported(cfg)
    flat = cfg.b_is_flat_ground_assumption
    dev = raw_scan.xyz.device
    stamp = torch.as_tensor(stamp, dtype=torch.float32, device=dev)
    mat = (..., None, None)   # a per-robot flag against (...,4,4)

    # -- drop-rate statistics (Locus.cc:401-423) ---------------------------
    stats = state.stats
    if seq is not None:
        seq = torch.as_tensor(seq, dtype=torch.int32, device=dev)
        gap = torch.clamp(seq - stats.last_seq - 1, min=0)
        gap = torch.where(stats.last_seq < 0, 0, gap)
        stats = stats._replace(dropped_msgs=stats.dropped_msgs + gap, last_seq=seq)

    # Stage scopes carry the JAX package's named_scope names; a
    # torch.profiler trace buckets host and device time by them
    # (tools/torch_stage_profile.py). Without a profiler they cost ~1 us.
    gen = _random_filter_generator(stats.scan_count) if cfg.filtering.random_filter else None
    with record_function("stage_pre"):
        scan = preprocess(raw_scan, state.voxel_leaf, cfg, generator=gen, open_space=state.open_space)
    num_points = scan.count()

    # -- adaptive input voxelization (Locus.cc:780-810): the new leaf
    # takes effect on the next scan. Frozen in feature mode: the leaf
    # shapes nothing upstream of the extractor, and the per-region
    # feature budget would read as a permanent "too few points".
    if cfg.b_adaptive_input_voxelization and not cfg.filtering.extract_features:
        next_leaf, _ = voxel.adaptive_leaf_update(
            state.voxel_leaf, num_points, cfg.points_to_process_in_callback,
            cfg.voxel_leaf_min, cfg.voxel_leaf_max,
        )
    else:
        next_leaf = state.voxel_leaf
    if cfg.b_monitor_space:
        open_space, xy_cross_section = _space_monitor(scan, cfg)
    else:
        open_space = state.open_space
        xy_cross_section = torch.full_like(state.voxel_leaf, -1.0)

    with record_function("stage_prior"):
        sel = fusion.integrate_sensors(state.fuse, stamp, stamp, cfg.fusion, prev_stamp=state.previous_stamp)

    # -- scan-to-scan ------------------------------------------------------
    with record_function("stage_s2s"):
        odo = odometry.update(state.odom, scan, prior=sel.prior, cfg=cfg.odometry, flat_ground=flat)

    # -- scan-to-submap ----------------------------------------------------
    loc0 = localization.motion_update(state.loc, odo.state.incremental)
    fixed = localization.transform_points_to_fixed_frame(loc0, scan)
    mp_impl = mapper_fabric(cfg.mapper)
    with record_function("stage_ann"):
        neighbors, ann_d2 = mp_impl.approx_nearest_neighbors(
            state.map, fixed, return_d2=True, radius=cfg.mapper.ann_search_radius
        )
    neighbors_sensor = localization.transform_points_to_sensor_frame(loc0, neighbors)
    with record_function("stage_s2m"):
        meas = localization.measurement_update(
            loc0, scan, neighbors_sensor, cfg=cfg.localization, flat_ground=flat
        )

    # On the first scan there is no map: keep the initial pose.
    have_map = state.map.num_keyframes > 0
    loc_state = localization.LocalizationState(
        *(torch.where(have_map.reshape(have_map.shape + (1,) * (new.dim() - have_map.dim())), new, old)
          for new, old in zip(meas.state, loc0))
    )
    pose = torch.where(
        have_map[mat],
        loc_state.integrated,
        torch.where(odo.performed[mat], odo.state.integrated, loc0.integrated),
    )

    # -- velocity buffer (for MSW gating) ----------------------------------
    dt = torch.clamp(stamp - state.previous_stamp, min=1e-3)
    first = state.previous_stamp < 0
    inc = loc_state.incremental
    v_t = torch.where(first, 0.0, se3.translation_norm(inc) / dt)
    v_r = torch.where(first, 0.0, se3.rotation_angle(se3.rotation(inc)) / dt)
    vb = state.velocities
    vi = (vb.ptr % vb.trans.shape[-1]).to(torch.int64)[..., None]
    vb = VelocityBuffer(
        trans=vb.trans.scatter(-1, vi, v_t[..., None]),
        rot=vb.rot.scatter(-1, vi, v_r[..., None]),
        ptr=vb.ptr + 1,
    )

    # -- keyframe policy (Locus.cc:514-543, open/closed space :571-576) ----
    delta_kf = se3.pose_delta(state.last_keyframe_pose, pose)
    t_thresh = torch.where(
        open_space,
        cfg.translation_threshold_open_space_kf,
        cfg.translation_threshold_closed_space_kf,
    )
    r_thresh = torch.where(
        open_space,
        cfg.rotation_threshold_open_space_kf,
        cfg.rotation_threshold_closed_space_kf,
    )
    moved = (se3.translation_norm(delta_kf) > t_thresh) | (
        se3.rotation_angle(se3.rotation(delta_kf)) > r_thresh
    )
    is_first = state.stats.scan_count == 0
    want_keyframe = (is_first | moved) & bool(cfg.b_add_keyframes_enabled)

    # Map updates are masked passes (enabled=flag), as in the JAX package;
    # the keyframe at map resolution preprocesses the raw scan again, so
    # it runs only when a keyframe is due (one host read; JAX: lax.cond).
    if cfg.mapper.keyframe_at_map_resolution:
        new_map = state.map
        if bool(want_keyframe):
            with record_function("stage_kf"):
                kf = raw_scan
                if cfg.filtering.body_filter:
                    kf = filters.crop_box(kf, cfg.filtering.box_min, cfg.filtering.box_max, negative=True)
                kf = voxel.voxel_downsample(
                    kf, cfg.mapper.map_voxel_leaf, capacity=cfg.mapper.keyframe_capacity, with_attributes=False
                )
                kf = normals_op.estimate_normals_radius(
                    kf, radius=cfg.filtering.normals_radius_scale * cfg.mapper.map_voxel_leaf
                )
                new_map = mp_impl.insert_keyframe(state.map, kf.transform(pose), cfg.mapper)
    elif cfg.b_add_keyframes_enabled:
        # Novelty distances come from the ANN pass at the predicted pose,
        # off from the final pose by the measurement correction (~cm).
        with record_function("stage_kf"):
            new_map = mp_impl.insert_keyframe(
                state.map, scan.transform(pose), cfg.mapper, nearest_d2=ann_d2, enabled=want_keyframe
            )
    else:
        new_map = state.map
    last_kf_pose = torch.where(want_keyframe[mat], pose, state.last_keyframe_pose)

    # -- MSW refresh (Locus.cc:536-538; velocity gates lo_settings:47-62) --
    if cfg.mapper.b_enable_msw:
        pos = se3.translation(pose)
        moved_msw = (
            se3.norm(pos - new_map.last_refresh_position)
            > cfg.mapper.translation_threshold_msw
        )
        slow = (torch.mean(vb.trans, dim=-1) < cfg.mapper.translational_velocity_threshold) & (
            torch.mean(vb.rot, dim=-1) < cfg.mapper.rotational_velocity_threshold
        )
        want_refresh = moved_msw & slow & (new_map.num_keyframes > 0)
        with record_function("stage_msw"):
            new_map = mp_impl.refresh_msw(new_map, pos, cfg.mapper, enabled=want_refresh)
    else:
        want_refresh = torch.zeros_like(want_keyframe)

    stats = stats._replace(
        scan_count=stats.scan_count + 1,
        keyframe_count=stats.keyframe_count + want_keyframe.to(torch.int32),
        rejected_scan_to_scan=stats.rejected_scan_to_scan
        + (odo.performed & ~odo.accepted).to(torch.int32),
        rejected_scan_to_map=stats.rejected_scan_to_map
        + (have_map & ~meas.accepted).to(torch.int32),
    )
    new_state = LocusState(
        odom=odo.state,
        loc=loc_state,
        map=new_map,
        fuse=sel.state,
        voxel_leaf=next_leaf,
        last_keyframe_pose=last_kf_pose,
        previous_stamp=stamp,
        velocities=vb,
        open_space=open_space,
        stats=stats,
    )
    out = StepOutput(
        pose=pose,
        covariance=loc_state.covariance,
        condition_number=loc_state.condition_number,
        prior_source=sel.source,
        scan_to_scan_accepted=odo.accepted,
        scan_to_map_accepted=meas.accepted & have_map,
        keyframe_inserted=want_keyframe,
        msw_refreshed=want_refresh,
        num_points=num_points,
        voxel_leaf=state.voxel_leaf,
        odom_iterations=odo.icp.iterations,
        loc_iterations=meas.icp.iterations,
        map_size=mp_impl.map_size(new_map),
        xy_cross_section=xy_cross_section,
    )
    return new_state, out
