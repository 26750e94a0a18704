"""The compiled step on the CPU: `pipeline.make_step` and
`runner.make_replay_step` against the JAX package's, the masked mode of
`ops.graph` against the eager one, and the capture discipline.

(a) make_step and make_replay_step with device="cpu" (the eager step, as
    `jax.jit` runs the same program on the CPU) against JAX's make_step and
    make_replay_step on test_torch_pipeline.py's 12-scan tunnel under
    small_cfg, chained scan by scan: pose within 1e-2 m and 1e-2 rad (that
    file's tolerance, and its reasons), keyframe decisions equal; the
    golden replay within 2 cm of golden_poses.npy (test_golden.py's gate);
    the outer-iteration lists of both stages, each package stepping once
    from JAX's state before every scan, equal or their difference
    explained on its scan (tests/torch_exp_cases.py's why_counts_differ).
(b) the masked mode (every gated body runs; each write keeps the old value
    where the gate is false) against the eager mode, bit for bit: the
    GICP (converging, capped with the re-lookup, batched, recomputed
    covariances) and the 12-scan replay. A CUDA graph's IF node records
    exactly such a body, so this holds the in-place discipline capture
    needs.
(c) the capture discipline: after a warm-up step, a step of each
    capturable configuration in masked mode under `ops.graph.no_host_reads`
    (no host read, no tensor from host data, no op whose output shape
    depends on data) raises nothing; each option outside `capturable`
    makes make_step and make_replay_step on "cuda" raise
    NotImplementedError naming it, before any device call (the CPU build
    of torch would fail any); the launch accounts of captured steps add up
    as the counters read them.
"""
import collections
import contextlib
import dataclasses
import os
from pathlib import Path

import jax  # noqa: F401  (JAX on the CPU before the port's modules, as in every test_torch_* file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import pipeline as jpl
from locus_tpu import runner as jrunner
from locus_tpu.config import FusionConfig
from locus_tpu.core.cloud import PointCloud as JPointCloud
from locus_tpu.io.dataset import Sequence
from locus_tpu_torch import config as tcfg_mod, pipeline as tpl, runner as trunner
from locus_tpu_torch.config import RegistrationConfig
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.io import synthetic
from locus_tpu_torch.ops import graph
from locus_tpu_torch.registration.gicp import gicp_register
from tests import torch_exp_cases as cases
from tests.test_pipeline import small_cfg
from tests.torch_helpers import load_tool, pose_diff

DATA = os.path.join(os.path.dirname(__file__), "data")
POSE_TOL_M = 1e-2
POSE_TOL_RAD = 1e-2
GOLDEN_TOL_M = 0.02
R = dataclasses.replace


def _jcfg():
    return small_cfg(fusion=FusionConfig(data_integration_mode=3))


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def tunnel():
    return cases.tunnel()


def _assert_poses_close(tp, jp):
    assert len(tp) == len(jp)
    for i, (a, b) in enumerate(zip(tp, jp)):
        dt, dr = pose_diff(a, b)
        assert dt < POSE_TOL_M and dr < POSE_TOL_RAD, (i, dt, dr)


# -- (a) against JAX's compiled entry points ---------------------------------

def test_make_step_matches_jax_make_step(tunnel):
    """The bare step (no sensor windows: pure lidar odometry), chained."""
    jcfg = _jcfg()
    tcfg = _port_cfg(jcfg)
    jstep, tstep = jpl.make_step(jcfg), tpl.make_step(tcfg, device="cpu")
    jst = cases.jax_state(jcfg, tunnel)
    tst = tpl.init_state(tcfg, initial_pose=torch.as_tensor(tunnel.gt_poses[0], dtype=torch.float32), device="cpu")
    jp, tp, jkf, tkf = [], [], [], []
    for i in range(len(tunnel)):
        xyz, mask = trunner.pack_scan(tunnel.scans[i], tunnel.scan_valid[i], tcfg.raw_scan_capacity)
        jraw = JPointCloud(jnp.asarray(xyz), jnp.zeros_like(xyz), jnp.zeros(xyz.shape[0], jnp.float32),
                                  jnp.asarray(mask))
        jst, jout = jstep(jst, jraw, jnp.float32(tunnel.stamps[i]), seq=jnp.int32(i))
        traw = trunner.raw_cloud(torch.from_numpy(xyz), torch.from_numpy(mask))
        tst, tout = tstep(tst, traw, torch.tensor(tunnel.stamps[i], dtype=torch.float32),
                          seq=torch.tensor(i, dtype=torch.int32))
        jp.append(np.asarray(jout.pose))
        tp.append(tout.pose.numpy())
        jkf.append(bool(jout.keyframe_inserted))
        tkf.append(bool(tout.keyframe_inserted))
    _assert_poses_close(tp, jp)
    assert tkf == jkf


def _replay(step, state, seq, cfg, to_numpy):
    poses, kf = [], []
    for i in range(len(seq)):
        args = trunner.scan_inputs(seq, i, cfg, "cpu")
        state, out = step(state, *(to_numpy(a) for a in args))
        poses.append(np.asarray(out.pose))
        kf.append(bool(out.keyframe_inserted))
    return np.stack(poses), kf


def test_make_replay_step_matches_jax_make_replay_step(tunnel):
    jcfg = _jcfg()
    tcfg = _port_cfg(jcfg)
    tseq = cases.port_seq(tunnel)
    jp, jkf = _replay(jrunner.make_replay_step(jcfg), cases.jax_state(jcfg, tunnel), tseq, tcfg,
                      lambda a: jnp.asarray(a.numpy()))
    tst = tpl.init_state(tcfg, initial_pose=torch.as_tensor(tunnel.gt_poses[0], dtype=torch.float32), device="cpu")
    tp, tkf = _replay(trunner.make_replay_step(tcfg, device="cpu"), tst, tseq, tcfg, lambda a: a)
    _assert_poses_close(tp, jp)
    assert tkf == jkf


def test_make_replay_step_golden_trajectory():
    seq = Sequence.load(os.path.join(DATA, "golden_seq.npz"))
    tcfg = _port_cfg(_jcfg())
    tseq = cases.port_seq(seq)
    tst = tpl.init_state(tcfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device="cpu")
    poses, _ = _replay(trunner.make_replay_step(tcfg, device="cpu"), tst, tseq, tcfg, lambda a: a)
    golden = np.load(os.path.join(DATA, "golden_poses.npy"))
    err = np.linalg.norm(poses[:, :3, 3] - golden[:, :3, 3], axis=1)
    assert err.max() < GOLDEN_TOL_M, err.max()


def test_make_replay_step_iteration_lists_match_jax(tunnel):
    """One step of each package's compiled replay step from JAX's state
    before every scan: both stages' outer-iteration counts equal, or the
    difference explained on that scan."""
    jcfg = _jcfg()
    tcfg = _port_cfg(jcfg)
    tseq = cases.port_seq(tunnel)
    jstep, tstep = jrunner.make_replay_step(jcfg), trunner.make_replay_step(tcfg, device="cpu")
    jst = cases.jax_state(jcfg, tunnel)
    unexplained = []
    for i in range(len(tunnel)):
        args = trunner.scan_inputs(tseq, i, tcfg, "cpu")
        before = cases.copy_jax(jst)
        _, tout = tstep(cases.port_state(before), *args)
        jst, jout = jstep(jst, *[jnp.asarray(a.numpy()) for a in args])
        for stage in ("odom_iterations", "loc_iterations"):
            port, jax_ = int(getattr(tout, stage)), int(getattr(jout, stage))
            if port != jax_ and cases.why_counts_differ(jcfg, tcfg, jstep, before, jst, args, stage, port) is None:
                unexplained.append((i, stage, port, jax_))
    assert not unexplained, unexplained


# -- (b) masked == eager, bit for bit -----------------------------------------

def _room(shift, seed=3):
    xyz, nrm = synthetic.hollow_cube(step=0.15, side=4.0, jitter=0.01, seed=seed)
    target = PointCloud.from_points(xyz, capacity=2048, normals=nrm, device="cpu")
    src = torch.where(target.mask[:, None], target.xyz - torch.tensor(shift, dtype=torch.float32), target.xyz)
    return PointCloud(src, target.normals, target.intensity, target.mask), target


GICP_CASES = {
    "converges": (RegistrationConfig(), 1),
    "capped_relookup": (RegistrationConfig(iterations=2, final_correspondence_relookup=True), 1),
    "batched": (RegistrationConfig(iterations=4), 2),
    "recompute": (RegistrationConfig(covariance_mode="recompute", iterations=6), 1),
}


@pytest.mark.parametrize("case", list(GICP_CASES))
def test_gicp_masked_matches_eager(case):
    cfg, batch = GICP_CASES[case]
    pairs = [_room((0.12, -0.06, 0.04)), _room((0.3, 0.1, -0.05), seed=4)][:batch]
    if batch > 1:
        src = PointCloud(*(torch.stack(x) for x in zip(*(p[0] for p in pairs))))
        tgt = PointCloud(*(torch.stack(x) for x in zip(*(p[1] for p in pairs))))
    else:
        src, tgt = pairs[0]
    eager = gicp_register(src, tgt, cfg=cfg)
    with graph.masked():
        masked = gicp_register(src, tgt, cfg=cfg)
    if case == "capped_relookup":
        assert not bool(eager.converged.all())      # the re-lookup ran
    for name, a, b in zip(eager._fields, eager, masked):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("outer,inner", [(True, True), (True, False), (False, True), (False, False)])
def test_gate_writes_only_where_its_predicates_hold(outer, inner):
    """gate/assign in eager and masked mode: a body's writes land only
    where every enclosing gate's predicate held (nested gates included),
    though the masked body always runs; a body may rewrite its own
    predicate (a loop's flag) without changing the mask it runs under."""
    def run(mode):
        counts = torch.zeros(3, dtype=torch.int32)
        flag = torch.tensor(outer)

        def body():
            graph.assign(counts, counts + torch.tensor([1, 0, 0], dtype=torch.int32))
            graph.assign(flag, torch.tensor(False))          # rewrites its own predicate
            graph.gate(torch.tensor(inner), lambda: graph.assign(counts, counts + torch.tensor(
                [0, 1, 0], dtype=torch.int32)), trips=counts)
            graph.assign(counts, counts + torch.tensor([0, 0, 1], dtype=torch.int32))

        with mode():
            ran = graph.gate(flag, body, trips=counts)
        return counts.tolist(), bool(flag), ran

    eager = run(contextlib.nullcontext)
    masked = run(graph.masked)
    want = [int(outer), int(outer and inner), int(outer)]
    assert eager[:2] == masked[:2] == (want, False)
    assert eager[2] == outer and masked[2] is True       # masked: the body ran, so a loop goes on


def test_replay_masked_matches_eager(tunnel):
    tcfg = _port_cfg(_jcfg())
    tseq = cases.port_seq(tunnel)
    eager, eo, _ = trunner.run_sequence(tseq, tcfg, device="cpu")
    with graph.masked():
        masked, mo, _ = trunner.run_sequence(tseq, tcfg, device="cpu")
    np.testing.assert_array_equal(masked, eager)
    assert mo == eo


# -- (c) the capture discipline --------------------------------------------

def _capturable_configs():
    base = _port_cfg(_jcfg())
    f = base.filtering
    return {
        "small": base,
        "knn_normals": base.replace(filtering=R(f, normals_method="knn")),
        "filters": base.replace(filtering=R(f, grid_filter=True, outlier_filter=True, radius_filter=True,
                                            radius=0.8, radius_knn=3)),
        "recompute_adaptive": base.replace(
            odometry=R(base.odometry, covariance_mode="recompute"),
            localization=R(base.localization, registration=R(base.localization.registration,
                                                             covariance_mode="adaptive"))),
        "flat_ground_space_monitor": base.replace(
            fusion=R(base.fusion, data_integration_mode=0), b_is_flat_ground_assumption=True, b_monitor_space=True),
        "imu_to_base": base.replace(fusion=R(base.fusion, data_integration_mode=2,
                                             b_convert_imu_to_base_link_frame=True)),
        "interpolated_odom": base.replace(fusion=R(base.fusion, b_integrate_interpolated_odom=True)),
    }


@pytest.mark.parametrize("name", list(_capturable_configs()))
def test_step_makes_no_host_read_after_warm_up(tunnel, name, monkeypatch):
    cfg = _capturable_configs()[name]
    assert tpl.capturable(cfg)
    tseq = cases.port_seq(tunnel)
    state = tpl.init_state_from_config(
        cfg, initial_pose=torch.as_tensor(tunnel.gt_poses[0], dtype=torch.float32), device="cpu")
    for i in range(3):
        # scan 0 warms up (the constants, LOCUS_DEBUG_CHECKS' host read), as
        # a captured step's warm-up does; the others run as capture would
        if i == 1:
            monkeypatch.delenv("LOCUS_DEBUG_CHECKS", raising=False)
        args = trunner.scan_inputs(tseq, i, cfg, "cpu")
        with graph.masked(), (graph.no_host_reads(name) if i else contextlib.nullcontext()):
            state, out = trunner.replay_step(state, *args, cfg=cfg)
    assert np.isfinite(out.pose.numpy()).all()


@pytest.mark.parametrize("what", ["item", "bool", "tensor", "as_tensor", "setitem", "list_index", "bool_index",
                                  "nonzero"])
def test_no_host_reads_names_each_kind(what):
    x = torch.arange(4.0)
    ops = {
        "item": lambda: x.sum().item(),
        "bool": lambda: bool(x.sum() > 0),
        "tensor": lambda: torch.tensor([1.0]),
        "as_tensor": lambda: torch.as_tensor((1.0, 2.0)),
        "setitem": lambda: x.clone().__setitem__(0, 1.0),
        "list_index": lambda: x[[0, 2]],
        "bool_index": lambda: x[x > 1],
        "nonzero": lambda: torch.nonzero(x),
    }
    with pytest.raises(graph.HostReadError, match="the probe"):
        with graph.no_host_reads("the probe"):
            ops[what]()
    index = graph.constant((0, 2), torch.int64, "cpu")    # made before, as the warm-up makes them
    with graph.no_host_reads():       # and what the step does instead passes
        x.clone()[0].fill_(1.0)
        torch.as_tensor(x)
        x[index]
        assert graph.constant((0, 2), torch.int64, "cpu") is index


def _blocked_configs():
    base = _port_cfg(_jcfg())
    reg = base.localization.registration
    return {
        "odometry.registration_method": base.replace(odometry=R(base.odometry, registration_method="ndt")),
        "localization.registration.registration_method": base.replace(
            localization=R(base.localization, registration=R(reg, registration_method="ndt"))),
        "mapper.structure": base.replace(mapper=R(base.mapper, structure="voxel_hash")),
        "filtering.extract_features": base.replace(filtering=R(base.filtering, extract_features=True)),
        "filtering.random_filter": base.replace(filtering=R(base.filtering, random_filter=True)),
        "mapper.keyframe_at_map_resolution": base.replace(mapper=R(base.mapper, keyframe_at_map_resolution=True)),
    }


@pytest.mark.parametrize("option", list(_blocked_configs()))
def test_uncapturable_config_raises_before_any_device_call(option):
    cfg = _blocked_configs()[option]
    assert not tpl.capturable(cfg)
    for make in (tpl.make_step, trunner.make_replay_step):
        with pytest.raises(NotImplementedError, match=option):
            make(cfg, device="cuda")
    # the replays take the eager step there, and say so
    _, _, report = trunner.run_sequence(cases.port_seq(cases.tunnel()), cfg, max_scans=1, device="cpu")
    assert report.captured is False


def test_mesh_is_not_captured():
    assert tpl.capture_blocker(_port_cfg(_jcfg()), mesh=object()).startswith("mesh=")


def test_capturable_covers_the_default_production_and_experiment_configs():
    _torch_tool = load_tool("_torch_tool")
    torch_exp_ablate, torch_exp_gap, torch_exp_gap2 = (load_tool(f"torch_exp_{t}") for t in ("ablate", "gap", "gap2"))
    bases = [tcfg_mod.LocusConfig(), tcfg_mod.production_config(), _port_cfg(small_cfg()), _port_cfg(_jcfg()),
             _torch_tool.fallback_config(),
             tcfg_mod.load_yaml(str(Path(__file__).resolve().parent.parent / "configs" / "husky.yaml"))]
    for base in bases:
        assert tpl.capturable(base), tpl.capture_blocker(base)
        for change in list(torch_exp_ablate.VARIANTS.values()) + list(torch_exp_gap.VARIANTS.values()):
            assert tpl.capturable(_torch_tool.ablated(base, **change))
        for change, _ in torch_exp_gap2.VARIANTS.values():
            assert tpl.capturable(_torch_tool.ablated(base, **change))
        for inner in (1, 2, 3, 5):      # tools/torch_exp_inner.py
            assert tpl.capturable(_torch_tool.ablated(base, inner_iterations=inner))


def test_launch_accounts_add_ungated_once_a_replay_and_regions_by_their_trips():
    """What `read_launches` adds for a captured step: its launches outside
    any gate once a replay, each gated region's times the trips it ran (as
    the graph sums them in its trips tensor)."""
    from locus_tpu_torch.ops.kernels import read_launches, reset_launches

    class Step:   # stands in for a CapturedStep (its record holds a weak reference)
        pass

    step = Step()
    reset_launches()
    record = graph._Record(step, collections.Counter({"moments_visits": 1, "nn_visits_map": 1}),
                           [collections.Counter({"nn_visits_scan": 1}), collections.Counter({"nn_visits_scan": 2})],
                           torch.zeros(graph._MAX_REGIONS, dtype=torch.int64))
    graph._register(record)
    record.trips[:2] += torch.tensor([7, 1])      # three replays: 2 + 3 + 2 trips, one re-lookup
    record.replays = 3
    counts = read_launches()
    assert (counts["moments_visits"], counts["nn_visits_map"], counts["nn_visits_scan"]) == (3, 3, 9)
    assert record.replays == 0 and not record.trips.any()
    assert read_launches()["nn_visits_scan"] == 9      # folded once
    del step
    reset_launches()
    graph.drop_replays()        # the record of a step that is gone, with nothing unread, goes
    assert record not in graph._records and read_launches()["nn_visits_scan"] == 0
