"""Typed configuration tree.

A field-for-field copy of `locus_tpu/config.py`: the port reads the same
profiles and YAML files, and `convert.config_from_dict` rebuilds it from
the JAX package's config.

Native replacement for LOCUS's four config mechanisms (rosparam YAML +
launch-file logic + dynamic_reconfigure + env vars — SURVEY §5.6): a
single dataclass tree with per-robot profiles and YAML loading.

Defaults mirror the reference production configs:
  locus/config/lo_settings.yaml
  point_cloud_odometry/config/parameters.yaml
  point_cloud_localization/config/parameters.yaml
  point_cloud_filter/config/parameters.yaml

Fields that shape traced programs (capacities, iteration counts, K) are
static Python ints so jit sees fixed shapes; runtime-mutable knobs (the
adaptive voxel leaf size) live in device state instead.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class RegistrationConfig:
    """GICP/NDT registration budget.

    Mirrors point_cloud_odometry/config/parameters.yaml (scan-to-scan
    profile) — scan-to-submap overrides via `localization_default()`.
    """

    registration_method: str = "gicp"  # "gicp" | "ndt"
    tf_epsilon: float = 0.001          # transformation_epsilon
    rotation_epsilon: float = 2e-3     # gicp.h:rotation_epsilon_ default
    corr_dist: float = 1.0             # max correspondence distance [m]
    iterations: int = 20               # outer ICP iterations
    # GN converges in 2-3 steps on these quadratic-per-linearization
    # objectives (validated: identical accuracy at 2/3/4/8 on cube + the
    # 5-world eval + the real garage chain — tools/exp_inner.py). 2 is
    # ~0.2 ms/scan faster on TPU and accuracy-neutral, but SHIPS AS 3:
    # with 2, outer-convergence deltas land near the epsilon boundary
    # where vmapped-vs-single f32 reduction-order differences flip an
    # outer iteration — breaking the batched==single determinism
    # contract by ~2.5 mm (measured: test_multi_robot_session and the
    # 2-process DP replay fail with 2 in either stage).
    inner_iterations: int = 3
    transform_thresholding: bool = True
    max_translation: float = 1.0       # gate on per-scan delta [m]
    max_rotation: float = 1.0          # gate on per-scan delta [rad]
    recompute_covariances: bool = False  # derive from normals (production path)
    # Re-search correspondences at the final pose when the outer loop
    # exits on the iteration cap (the reference always re-searches,
    # PointCloudLocalization.cc:327-336; at convergence the carried
    # pairs are within epsilon, so the extra NN pass is gated behind
    # the not-converged branch and costs nothing on the common path).
    final_correspondence_relookup: bool = True
    covariance_mode: str = "normals"   # "normals" | "recompute" | "adaptive"
    gicp_epsilon: float = 0.001        # plane-disk small eigenvalue
    k_correspondences: int = 20        # K for covariance estimation
    # NDT-specific
    ndt_resolution: float = 1.0
    ndt_step_size: float = 0.1
    levenberg_lambda: float = 1e-6     # GN damping (not in reference; tiny)
    # NDT optimizer: "irls" reshapes the solve as iteratively-reweighted
    # GN (batched; TPU default), "newton" follows the reference's
    # Newton-direction + line-search scheme (ndt_omp_impl.hpp
    # computeDerivatives/computeStepLengthMT) on the SE(3) tangent.
    ndt_optimizer: str = "irls"
    # IRLS warm-start iterations for the "newton" optimizer (0 = pure
    # reference scheme). The reference's Newton+Moré–Thuente step is
    # clamped to ndt_step_size along a normalized direction and declares
    # convergence when the accepted step drops under tf_epsilon — from a
    # far initial basin it stalls on a score plateau (measured on the
    # real garage pair: consistency 0.16–0.27 vs the GICP alignment).
    # Its production use survives because priors keep it near the
    # optimum; here a few full-GN IRLS iterations on the same objective
    # reach the basin first (a deliberate robustness addition over
    # ndt_omp_impl.hpp:888-1060's raw scheme). The warm-start loop exits
    # as soon as its own scaled-delta test converges, so a generous cap
    # costs nothing when the prior is good. Measured on the garage
    # battery: warm-started newton+direct7 goes from 0.26/0.12
    # consistency (stalled) to ~0.01-0.02 at 2 m/1 m voxels.
    ndt_newton_warmstart: int = 8
    # Line search for the "newton" optimizer: "more_thuente" runs the
    # reference's Moré–Thuente interval machine (computeStepLengthMT,
    # ndt_omp_impl.hpp:888-1060: mu=1e-4, nu=0.9, <=10 trials,
    # step_max=ndt_step_size, step_min=tf_epsilon/2) as a scalar
    # lax.while_loop — each trial is one fused score+gradient pass;
    # "armijo" is the cheaper 5-candidate backtracking variant.
    ndt_line_search: str = "more_thuente"
    # NDT voxel neighborhood (the reference's NeighborSearchMethod,
    # ndt_omp.h:51): "direct1" | "direct7" | "direct26" | "kdtree".
    # KDTREE reproduces the reference's radius search over occupied-leaf
    # centroids at `ndt_resolution` (voxel_grid_covariance_omp.h:433-449)
    # as a DIRECT26-style 3x3x3 hashed gather gated by centroid distance
    # <= resolution. Candidate count is shape-defining: 1, 7, or 27
    # hashed gathers per point.
    ndt_neighborhood: str = "direct7"

    @staticmethod
    def localization_default() -> "RegistrationConfig":
        """Scan-to-submap profile (point_cloud_localization/config/parameters.yaml)."""
        return RegistrationConfig(
            tf_epsilon=1e-5,
            corr_dist=0.2,
            iterations=20,
            inner_iterations=3,
        )


@dataclass(frozen=True)
class LocalizationConfig:
    registration: RegistrationConfig = field(
        default_factory=RegistrationConfig.localization_default
    )
    compute_icp_covariance: bool = True
    # 1 = point-to-plane. The reference removed method 0 (point-to-point)
    # and hard-errors on it (PointCloudLocalization.cc:403-419); other
    # values raise ValueError at step-build time here.
    icp_covariance_method: int = 1
    icp_max_covariance: float = 0.01
    compute_icp_observability: bool = False
    normal_search_radius: float = 10.0


@dataclass(frozen=True)
class FilterConfig:
    """point_cloud_filter/config/parameters.yaml equivalents."""

    grid_filter: bool = False
    grid_res: float = 0.2
    random_filter: bool = False
    decimate_percentage: float = 0.90
    decimate_percentage_open_space: float = 0.93
    outlier_filter: bool = False
    outlier_std: float = 1.0
    outlier_knn: int = 10
    radius_filter: bool = False
    radius: float = 0.15
    radius_knn: int = 3
    extract_features: bool = False
    feature_width: int = 900   # range-image azimuth bins (match sensor resolution)
    # body crop box (BodyFilter nodelet; per-robot defaults from
    # locus/config/body_filter_params_husky.yaml)
    body_filter: bool = True
    box_min: tuple = (-0.6, -0.6, -0.6)
    box_max: tuple = (0.6, 0.6, 0.6)
    # normal computation (NormalComputation nodelet). "radius" uses the
    # fused moments kernel with radius = normals_radius_scale * leaf
    # (TPU fast path); "knn" matches pcl's k-search exactly.
    normals_k: int = 20
    normals_method: str = "radius"     # "radius" | "knn"
    normals_radius_scale: float = 2.5


@dataclass(frozen=True)
class MapperConfig:
    """Keyframe sliding-window map (lo_settings.yaml sliding-window block)."""

    b_enable_msw: bool = True
    box_filter_size: float = 20.0
    translation_threshold_msw: float = 5.0
    rotational_velocity_threshold: float = 1.0
    translational_velocity_threshold: float = 0.1
    velocity_buffer_size: int = 10
    map_voxel_leaf: float = 0.15       # map store dedup resolution
    ann_search_radius: float = 2.0     # map 1-NN search bound (hits beyond
    # this are masked; consumers gate at corr_dist/leaf scales anyway)
    map_capacity: int = 1 << 17        # padded map point budget (131072)
    keyframe_capacity: int = 8192      # padded points per inserted keyframe
    # Insert keyframes at map resolution from the raw scan instead of the
    # adaptively-coarsened input scan. Default OFF: long-run evaluation
    # shows matched scan/map resolution tracks best (coarse-scan cell
    # centroids sit off-surface; registering them against a finer map
    # biases the corrections — ATE 1.5 m matched vs 4.1/7.5/17.2 m for
    # 0.15/0.10/0.05-leaf dense maps over a 168 m run). The reference
    # gets away with raw maps because its octree stores raw points, not
    # centroid lattices.
    keyframe_at_map_resolution: bool = False
    num_shards: int = 1                # map point-axis shards (mesh axis "map")
    # Map structure (the reference's mapperFabric choice of octree /
    # multithreaded / ikd-tree, lo_settings.yaml:49-58):
    #   "ring"       — ring-buffer point store with ANN novelty dedup
    #                  (default; octree-mapper analog)
    #   "voxel_hash" — spatial-hash slotted store, one point per map
    #                  voxel, O(1) dedup on insert (ikd-tree
    #                  downsample-on-insert analog)
    structure: str = "ring"


@dataclass(frozen=True)
class FusionConfig:
    """Sensor-prior integration (lo_settings.yaml data_integration +
    dynamic-switching block)."""

    data_integration_mode: int = 3     # 0 none, 1 imu, 2 imu-yaw, 3 odom
    sensor_health_timeout: float = 0.4
    imu_buffer_size: int = 128
    odometry_buffer_size: int = 128
    max_buffer_staleness: float = 0.1  # GetMsgAtTime rejection (Locus.cc:853-887)
    b_integrate_interpolated_odom: bool = False
    # IMU->base_link extrinsic conversion (LoadCalibrationFromTfTree +
    # IntegrateImu conjugation, Locus.cc:696-731, 1017-1042): when set,
    # every IMU orientation delta is conjugated into the base frame by
    # imu_to_base_quat (wxyz; rotation of the imu frame expressed in
    # base_link — load from the sensors YAML via
    # io.sensors.load_imu_calibration_quat).
    b_convert_imu_to_base_link_frame: bool = False
    imu_to_base_quat: tuple = (1.0, 0.0, 0.0, 0.0)


@dataclass(frozen=True)
class MergerConfig:
    """point_cloud_merger parameters."""

    number_of_velodynes: int = 1
    b_use_random_filter: bool = False
    decimate_percentage: float = 0.9
    b_use_radius_filter: bool = False
    radius: float = 0.15
    radius_knn: int = 3
    # upstream pcl/PassThrough per lidar (locus.launch:90-133: z ±100)
    b_use_passthrough: bool = True
    passthrough_limit: float = 100.0


@dataclass(frozen=True)
class LocusConfig:
    """Top-level config (lo_settings.yaml)."""

    # -- capacities (static; shape-defining) --
    scan_capacity: int = 4096          # padded per-scan point budget
    raw_scan_capacity: int = 32768     # pre-voxelization budget (merged)

    # -- orchestrator --
    odom_pub_rate: float = 10.0
    # Keyframe thresholds: the reference's base translation/rotation_
    # threshold_kf params are the *initial* values of the active
    # thresholds, overwritten by the space monitor (Locus.cc:571-576);
    # here the closed-space variants ARE the defaults (identical values)
    # and open_space state selects between the two profiles.
    translation_threshold_closed_space_kf: float = 1.0
    rotation_threshold_closed_space_kf: float = 0.3
    translation_threshold_open_space_kf: float = 2.0
    rotation_threshold_open_space_kf: float = 0.6
    xy_cross_section_threshold: float = 2500.0
    b_monitor_space: bool = False      # in-graph localizer-space monitor
    b_publish_xy_cross_section: bool = True
    b_is_flat_ground_assumption: bool = False
    b_add_keyframes_enabled: bool = True
    b_enable_computation_time_profiling: bool = True
    b_run_with_gt_point_cloud: bool = False
    gt_point_cloud_filename: Optional[str] = None
    # Fiducial-calibration initial pose (PointCloudOdometry.cc:50-70 /
    # PointCloudLocalization.cc:50-63): when set, init_state_from_config
    # starts the integrated estimates here instead of identity.
    fiducial_position: Optional[tuple] = None          # (x, y, z)
    fiducial_orientation_wxyz: Optional[tuple] = None  # (w, x, y, z)
    map_publishment_meters: int = 1
    statistics_time_window: float = 5.0

    # -- adaptive input voxelization (Locus.cc:780-810) --
    b_adaptive_input_voxelization: bool = True
    points_to_process_in_callback: int = 3000
    voxel_leaf_min: float = 0.01
    voxel_leaf_max: float = 5.0

    # -- subsystems --
    odometry: RegistrationConfig = field(default_factory=RegistrationConfig)
    localization: LocalizationConfig = field(default_factory=LocalizationConfig)
    filtering: FilterConfig = field(default_factory=FilterConfig)
    mapper: MapperConfig = field(default_factory=MapperConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    merger: MergerConfig = field(default_factory=MergerConfig)

    # ---------------------------------------------------------------------
    def replace(self, **kw) -> "LocusConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def robot_profile(robot: str) -> "LocusConfig":
        """Per-robot specialization (reference launch-file logic,
        locus/launch/locus.launch:13-84: husky vs spot)."""
        cfg = LocusConfig()
        if robot.startswith("husky"):
            return cfg.replace(
                merger=MergerConfig(number_of_velodynes=3),
            )
        if robot.startswith("spot"):
            return cfg.replace(
                fusion=dataclasses.replace(
                    cfg.fusion,
                    data_integration_mode=1,
                    b_integrate_interpolated_odom=True,
                ),
                localization=dataclasses.replace(
                    cfg.localization,
                    registration=dataclasses.replace(
                        cfg.localization.registration, iterations=25
                    ),
                ),
            )
        return cfg


def _update_dataclass(obj, data: dict):
    """Recursively apply a nested dict onto a (frozen) dataclass tree."""
    changes = {}
    for f in dataclasses.fields(obj):
        if f.name not in data:
            continue
        v = data[f.name]
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            changes[f.name] = _update_dataclass(cur, v)
        else:
            changes[f.name] = tuple(v) if isinstance(v, list) and isinstance(cur, tuple) else v
    return dataclasses.replace(obj, **changes)


def load_yaml(path: str, base: Optional[LocusConfig] = None) -> LocusConfig:
    """Load a YAML profile on top of defaults (≈ rosparam load)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _update_dataclass(base or LocusConfig(), data)
