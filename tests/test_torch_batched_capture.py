"""The batched replay step as the card captures it (`runner.make_batched_replay`
on a capturable configuration: one CUDA graph a tick), checked on the CPU.

The capture records the step once and replays it; on the CPU the same step
runs in masked mode (`ops.graph.masked()`: every gated body runs, its
writes kept where the gate held), which is how the capture's warm-up runs
it and what the graph's IF nodes compute. At small_cfg size (the mode-3
prior), B = 2 and B = 4 robots on 12-scan tunnels of their own (the
replays take the first SCANS scans):

(a) the masked batched step equals the eager batched replay, and each
    member its own single replay (`make_scan_replay`), every step output
    bit for bit;
(b) after its first tick the masked batched step makes no host read
    (`ops.graph.no_host_reads`), so a tick captures whole;
(c) the GICP loops' program counters (`ops.graph.count`) hold, in each
    stage, the member-trips run (B times the slowest member's iterations)
    and those the members needed (their own iterations), as the step
    outputs say;
(d) a batched state is no capture blocker; a mesh still is;
(e) a launch and a count are recorded by the mode (a capture's warm-up
    records neither), and `drop_counters` forgets an eager call's counters.

The card's own tests (tests/test_torch_gpu.py) hold the captured graph to
the eager replay and to each robot's captured single replay.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from locus_tpu.config import FusionConfig
from locus_tpu_torch import pipeline, runner
from locus_tpu_torch.config import RegistrationConfig
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.io import synthetic
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.metrics import RateReport
from locus_tpu_torch.ops import graph, kernels
from locus_tpu_torch.registration.gicp import gicp_register
from tests.test_pipeline import small_cfg

SCANS = 4
TUNNELS = ((0.3, 1), (0.4, 2), (0.35, 3), (0.45, 4))    # (step, seed) of robot b's tunnel
STAGES = {"stage_s2s": "odom_iterations", "stage_s2m": "loc_iterations"}


def _cfg():
    return config_from_dict(dataclasses.asdict(small_cfg(fusion=FusionConfig(data_integration_mode=3))))


def _host(out):
    return [x.numpy().copy() for x in out]


@functools.lru_cache(maxsize=None)
def _runs(batch):
    """(eager outputs, masked outputs, each robot's single outputs, the
    eager run's counters, the masked run's counters); outputs a list per
    tick of numpy fields."""
    cfg = _cfg()
    assert pipeline.capturable(cfg)
    seqs = [make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=st, seed=s) for st, s in TUNNELS[:batch]]
    packed = [runner.pack_sequence(s, cfg, max_scans=SCANS, device="cpu") for s in seqs]
    stacked = runner.stack_packed(packed)
    init = np.stack([s.gt_poses[0] for s in seqs])

    graph.drop_counters()
    eager = []
    runner.make_batched_replay(cfg)(pipeline.init_states(cfg, init, device="cpu"), stacked, outputs=eager)
    eager_counters = graph.read_counters()

    graph.drop_counters()
    masked, state = [], pipeline.init_states(cfg, init, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        for i in range(SCANS):
            # tick 0 warms up (the constants, LOCUS_DEBUG_CHECKS' host read),
            # as the capture's warm-up does; the others run as the graph would
            if i == 1:
                mp.delenv("LOCUS_DEBUG_CHECKS", raising=False)
            args = [stacked[k][i] for k in runner.PACKED_KEYS]
            with graph.masked(), (graph.no_host_reads("the batched step") if i else contextlib.nullcontext()):
                state, out = runner.replay_step(state, *args, cfg=cfg)
            masked.append(_host(out))
    masked_counters = graph.read_counters()

    single, singles = runner.make_scan_replay(cfg), []
    for s, p in zip(seqs, packed):
        outs = []
        single(pipeline.init_state(cfg, initial_pose=torch.as_tensor(s.gt_poses[0], dtype=torch.float32),
                                   device="cpu"), p, outputs=outs)
        singles.append([_host(o) for o in outs])
    return [_host(o) for o in eager], masked, singles, eager_counters, masked_counters


@pytest.mark.parametrize("batch", [2, 4])
def test_batched_step_masked_matches_eager_and_each_single(batch):
    eager, masked, singles, _, _ = _runs(batch)
    fields = pipeline.StepOutput._fields
    for i in range(SCANS):
        for name, a, b in zip(fields, masked[i], eager[i]):
            np.testing.assert_array_equal(a, b, err_msg=f"tick {i}: {name}, masked against eager")
        for r in range(batch):
            for name, a, b in zip(fields, masked[i], singles[r][i]):
                np.testing.assert_array_equal(a[r], b, err_msg=f"tick {i}, robot {r}: {name}, against its single")
    loc = np.stack([o[fields.index("loc_iterations")] for o in masked])      # (ticks, B)
    assert (loc.max(axis=1) != loc.min(axis=1)).any()       # the members' loops part ways


@pytest.mark.parametrize("batch", [2, 4])
def test_batched_step_makes_no_host_read_after_warm_up(batch):
    _, masked, _, _, _ = _runs(batch)       # ticks 1.. ran under graph.no_host_reads
    poses = np.stack([o[0] for o in masked])
    assert poses.shape == (SCANS, batch, 4, 4) and np.isfinite(poses).all()


@pytest.mark.parametrize("batch", [2, 4])
def test_frozen_trip_counters_match_the_step_outputs(batch):
    """Per stage: member-trips run = B x the slowest member's iterations,
    needed = the members' own, summed over the ticks; the frozen trips
    B x trips - sum(iterations) are their difference, in eager and masked
    mode alike."""
    eager, _, _, eager_counters, masked_counters = _runs(batch)
    fields = pipeline.StepOutput._fields
    want = {}
    for stage, field in STAGES.items():
        its = np.stack([o[fields.index(field)] for o in eager]).astype(np.int64)       # (ticks, B)
        want[f"{stage}/gicp.member_trips_run"] = int(batch * its.max(axis=1).sum())
        want[f"{stage}/gicp.member_trips_needed"] = int(its.sum())
    assert eager_counters == want
    assert masked_counters == want
    frozen = sum(want[f"{s}/gicp.member_trips_run"] - want[f"{s}/gicp.member_trips_needed"] for s in STAGES)
    assert frozen > 0           # some member waited for a slower one


def test_counter_outside_a_stage_and_inside_a_gate():
    graph.drop_counters()
    graph.count("probe", torch.tensor(3, dtype=torch.int32))
    with graph.stage("stage_probe"):
        graph.count("probe", torch.tensor(4))
    graph.count("probe", torch.tensor(1))
    got = graph.read_counters()
    assert (got["probe"], got["stage_probe/probe"]) == (4, 4)
    with pytest.raises(RuntimeError, match="inside a gated body"):
        with graph.masked():
            graph.gate(torch.tensor(True), lambda: graph.count("probe", torch.tensor(1)), trips=torch.tensor(0))
    graph.drop_counters()            # no captured step adds into them: forgotten
    assert "probe" not in graph.read_counters() and "stage_probe/probe" not in graph.read_counters()


def test_an_eager_counter_outside_a_stage_is_gone_after_a_drop():
    """An eager batched `gicp_register` outside any stage makes counters
    of its own; `drop_counters` forgets them, so a batched step run after
    the drop reads exactly its stages' four counters."""
    cube, nrm = synthetic.hollow_cube(step=0.2)
    src = PointCloud.from_points(cube, capacity=512, normals=nrm)
    moved = src.transform(se3.make_transform(se3.so3_exp(torch.tensor([0.0, 0.0, 0.05])), torch.tensor([0.1, 0.0, 0.0])))
    gicp_register(pipeline.stack_states([src, src]), pipeline.stack_states([src, moved]),
                  torch.stack([se3.identity()] * 2), RegistrationConfig(iterations=2))
    assert {"gicp.member_trips_run", "gicp.member_trips_needed"} <= set(graph.read_counters())
    graph.drop_counters()
    assert graph.read_counters() == {}
    cfg = _cfg()
    seqs = [make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=st, seed=s) for st, s in TUNNELS[:2]]
    stacked = runner.stack_packed([runner.pack_sequence(s, cfg, max_scans=2, device="cpu") for s in seqs])
    runner.make_batched_replay(cfg)(pipeline.init_states(cfg, np.stack([s.gt_poses[0] for s in seqs]), device="cpu"),
                                    stacked)
    assert set(graph.read_counters()) == {f"{stage}/gicp.member_trips_{k}" for stage in STAGES for k in ("run", "needed")}


def test_a_warm_up_records_no_launch_and_no_count():
    """Where a launch and a count go, by the mode: eager and masked, the
    ledger and the counter; inside `uncounted()` the launch goes nowhere;
    a captured step's warm-up records neither, but makes the counter."""
    graph.drop_counters()
    kernels.reset_launches()
    kernels.count_launch("eigh6")
    with graph.masked():
        kernels.count_launch("eigh6")
        graph.count("probe", torch.tensor(2))
    with kernels.uncounted():
        kernels.count_launch("eigh6")
    with graph._masked(recording=False):
        kernels.count_launch("eigh6")
        graph.count("probe", torch.tensor(5))
        graph.count("warm_only", torch.tensor(7))
    assert kernels.read_launches()["eigh6"] == 2
    assert graph.read_counters() == {"probe": 2, "warm_only": 0}
    kernels.reset_launches()
    graph.drop_counters()


def test_a_batched_state_captures_and_a_mesh_still_raises():
    """No check refuses a batched state: the batched replay takes the
    captured step on the card (its graph named for its stamps), and the
    eager step on the CPU, under `use_pallas=False` and with a mesh."""
    cfg = _cfg()
    assert not hasattr(pipeline, "check_single")
    step, captured = runner._stepper(cfg, torch.device("cuda"), None, runner.BATCHED_REPLAY_STEP)
    assert captured and step.name == "runner.batched_replay_step" and step.graph is None    # captured at its first call
    assert runner._stepper(cfg, torch.device("cpu"))[1] is False
    assert pipeline.capture_blocker(cfg, mesh=object()).startswith("mesh=")
    assert runner._stepper(cfg, torch.device("cuda"), object())[1] is False
    with pytest.raises(NotImplementedError, match="mesh="):
        pipeline.check_capturable(cfg, mesh=object())
    seqs = [make_tunnel_sequence(num_scans=1, azimuth_steps=256, step=st, seed=s) for st, s in TUNNELS[:2]]
    stacked = runner.stack_packed([runner.pack_sequence(s, cfg, device="cpu") for s in seqs])
    states = pipeline.init_states(cfg, np.stack([s.gt_poses[0] for s in seqs]), device="cpu")
    for use_pallas in (None, False):
        report = RateReport()
        runner.make_batched_replay(cfg, use_pallas=use_pallas)(states, stacked, report=report)
        assert report.captured is False and len(report.durations) == 1
