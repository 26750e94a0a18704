"""The step's own measurement: `ops.graph.stage` (the step's stage scopes,
stamped on the device inside a captured graph), the replay records of a
captured step (`replay_records`, `drop_replays`), the flag that switches
them (`b_enable_computation_time_profiling`), and `diagnostics.StageTimer`
with the merger's spans.

The CPU tests hold what runs without a card: the scopes as
`record_function`s, the bookkeeping of the host rows, the timer. The tests
marked `gpu` capture the step on the card; this file imports neither JAX
nor `locus_tpu`, so they run there:

    python -m pytest --noconftest -m gpu tests/test_torch_replay_records.py
"""
import collections
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from locus_tpu_torch import config as cfg_mod, diagnostics, merger, pipeline, runner
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.ops import graph

torch.set_num_threads(2)

STAGES = ("stage_pre", "stage_prior", "stage_s2s", "stage_ann", "stage_s2m", "stage_kf", "stage_msw")


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none. Decided here,
    at run time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_records():
    """Every test starts and ends with no replay record kept."""
    graph.drop_replays()
    yield
    graph.drop_replays()


def _names(prof, prefix):
    return [e.name for e in prof.events() if e.name.startswith(prefix)]


def _small_cfg(**changes):
    cfg = cfg_mod.LocusConfig(
        scan_capacity=1024,
        raw_scan_capacity=4096,
        points_to_process_in_callback=800,
        filtering=cfg_mod.FilterConfig(body_filter=True, normals_k=12),
        mapper=cfg_mod.MapperConfig(map_capacity=8192, keyframe_capacity=1024, map_voxel_leaf=0.1),
    )
    return dataclasses.replace(cfg, **changes)


# -- the CPU ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eager", "masked"])
def test_stage_outside_a_capture_is_its_record_function(mode, no_records):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with (graph.masked() if mode == "masked" else graph.stage("outer_scope")):
            with graph.stage("stage_test"):
                x = torch.ones(3) + 1
    assert _names(prof, "stage_test") == ["stage_test"]
    assert x.tolist() == [2.0, 2.0, 2.0]
    assert graph.replay_records() == []


def test_a_stage_passes_its_body_s_exception_on():
    with pytest.raises(ValueError, match="inside"):
        with graph.stage("stage_test"):
            raise ValueError("inside")


def test_the_eager_step_scopes_its_seven_stages(no_records):
    """pipeline.step's stage scopes keep their names: a profiler trace of
    the eager step on the CPU holds each of the seven once, and a replay
    on the CPU keeps no record."""
    seq = make_tunnel_sequence(num_scans=2, azimuth_steps=128, step=0.3, seed=1)
    cfg = _small_cfg()
    state = pipeline.init_state(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device="cpu")
    rstep = runner.make_replay_step(cfg, "cpu")
    state, _ = rstep(state, *runner.scan_inputs(seq, 0, cfg, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rstep(state, *runner.scan_inputs(seq, 1, cfg, "cpu"))
    assert sorted(_names(prof, "stage_")) == sorted(STAGES)
    assert graph.replay_records() == []


class _FakeCaptured:
    """Stands in for ops.graph.CapturedStep: keeps what it was built with."""

    made = []

    def __init__(self, fn, name, stamps=False):
        self.stamps = stamps
        _FakeCaptured.made.append(self)


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("creator", ["runner.make_replay_step", "pipeline.make_step"])
def test_both_creators_pass_the_profiling_flag(monkeypatch, creator, flag):
    """The switch is LOCUS's b_enable_computation_time_profiling, passed by
    both creators of a captured step."""
    monkeypatch.setattr(runner, "CapturedStep", _FakeCaptured)
    monkeypatch.setattr(graph, "CapturedStep", _FakeCaptured)
    _FakeCaptured.made = []
    cfg = _small_cfg(b_enable_computation_time_profiling=flag)
    (runner.make_replay_step if creator.startswith("runner") else pipeline.make_step)(cfg, torch.device("cuda"))
    assert [m.stamps for m in _FakeCaptured.made] == [flag]


def test_the_flag_is_on_by_default():
    assert cfg_mod.LocusConfig().b_enable_computation_time_profiling is True


class _Owner:
    """A stand-in for a captured step that owns a record."""


def _keep(rec, owner):
    """Keep the stamps `rec` in a record of `owner`'s, as a capture does."""
    graph._register(graph._Record(owner, collections.Counter(), [], torch.zeros(graph._MAX_REGIONS, dtype=torch.int64),
                                  stamps=rec))


def _kept_stamps():
    return [r.stamps for r in graph._records if r.stamps is not None]


def _host_record(replays):
    rec = graph._Stamps("test.step", torch.device("cpu"))
    rec.stages = [("stage_a", 1, 2)]
    rec.slots, rec.tail = 4, 3
    for k in range(replays):
        rec.add((3 * k, 3 * k + 1, 3 * k + 2))
    return rec


@pytest.mark.parametrize("replays", [5, graph.STAMP_ROWS + 3])
def test_host_rows_sit_at_the_replay_index_modulo_the_ring(replays, no_records):
    rec = _host_record(replays)
    owner = _Owner()
    _keep(rec, owner)
    (got,) = graph.replay_records()
    assert got["replays"] == replays and got["step"] == "test.step"
    assert got["stages"] == ["stage_a"] and got["stage_slots"] == [(1, 2)]
    assert (got["head_slot"], got["tail_slot"]) == (0, 3)
    assert got["device_ns"].shape == (min(replays, graph.STAMP_ROWS), 4)
    host = got["host_ns"]
    assert host.shape == (min(replays, graph.STAMP_ROWS), 3)
    last = replays - 1
    assert host[last % graph.STAMP_ROWS].tolist() == [3 * last, 3 * last + 1, 3 * last + 2]
    if replays > graph.STAMP_ROWS:
        oldest = replays - graph.STAMP_ROWS
        assert host[replays % graph.STAMP_ROWS, 0] == 3 * oldest


def test_reading_the_records_consumes_nothing_and_drop_starts_again(no_records):
    owner = _Owner()
    rec = _host_record(4)
    _keep(rec, owner)
    first, second = graph.replay_records(), graph.replay_records()
    assert len(first) == len(second) == 1
    np.testing.assert_array_equal(first[0]["host_ns"], second[0]["host_ns"])
    graph.drop_replays()
    assert graph.replay_records() == [] and _kept_stamps() == [rec]
    rec.add((1, 2, 3))
    assert graph.replay_records()[0]["replays"] == 1


def test_records_outlive_their_step_until_dropped(no_records):
    owner = _Owner()
    rec = _host_record(2)
    _keep(rec, owner)
    del owner
    assert graph.replay_records()[0]["replays"] == 2
    graph.drop_replays()
    assert _kept_stamps() == []


def test_stage_timer_keeps_start_and_end():
    timer = diagnostics.StageTimer()
    before = time.perf_counter_ns()
    with timer.time("scan_to_map"):
        time.sleep(0.002)
    after = time.perf_counter_ns()
    (start, end), = timer.spans("scan_to_map").tolist()
    assert before <= start < end <= after and end - start >= 2_000_000
    assert timer.summary()["scan_to_map"]["mean_s"] == pytest.approx((end - start) * 1e-9)
    assert timer.spans("never").shape == (0, 2)


def test_stage_timer_stays_bounded():
    timer = diagnostics.StageTimer(keep=4)
    for k in range(10):
        timer.span("lidar_callback", 10 * k, 10 * k + k + 1)
    assert timer.spans("lidar_callback").tolist() == [[10 * k, 11 * k + 1] for k in range(6, 10)]
    assert timer.summary()["lidar_callback"]["count"] == 4


def test_stage_timer_summary_keeps_its_form():
    timer = diagnostics.StageTimer()
    samples = [0.001, 0.002, 0.004, 0.003]
    for s in samples:
        timer.record("scan_to_scan", s)
    with timer.time("lidar_callback"):
        pass
    s = timer.summary()
    assert set(s) == {"scan_to_scan", "lidar_callback"}
    assert s["scan_to_scan"] == {"mean_s": float(np.mean(samples)), "p95_s": float(np.percentile(samples, 95)),
                                 "count": 4}
    assert set(s["lidar_callback"]) == {"mean_s", "p95_s", "count"}


def test_stage_timer_spans_are_record_functions_of_one_class():
    timer = diagnostics.StageTimer()
    assert type(timer.time("a")) is type(timer.time("b"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.time("lidar_callback"):
            torch.ones(2) * 2
    assert _names(prof, "lidar_callback") == ["lidar_callback"]


def test_the_merger_spans_each_call():
    timer = diagnostics.process_timer
    before = {k: timer.spans(f"merger.{k}").shape[0] for k in ("observe", "health", "merge")}
    state = merger.init_state(2, device="cpu")
    state = merger.observe(state, 0, 1.0)
    state = merger.observe(state, 1, 1.0)
    alive = merger.health(state, 1.05)
    cloud = PointCloud.from_points(np.ones((4, 3), np.float32), capacity=8, device="cpu")
    merger.merge([cloud, cloud], [np.eye(4, dtype=np.float32)] * 2, alive,
                 cfg=cfg_mod.MergerConfig(number_of_velodynes=2))
    after = {k: timer.spans(f"merger.{k}").shape[0] for k in ("observe", "health", "merge")}
    assert {k: after[k] - before[k] for k in after} == {"observe": 2, "health": 1, "merge": 1}


# -- the card -----------------------------------------------------------------

def _replay(cfg, seq, dev):
    """48 sweeps through make_scan_replay from a fresh state: (poses, map
    sizes) on the host, and the records the replays left."""
    graph.drop_replays()
    packed = runner.pack_sequence(seq, cfg, device=dev)
    state = pipeline.init_state_from_config(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32),
                                            device=dev)
    _, (poses, _, sizes) = runner.make_scan_replay(cfg)(state, packed)
    return poses.cpu().numpy(), sizes.cpu().numpy(), graph.replay_records()


@pytest.mark.gpu
def test_stamps_leave_every_output_bit_equal_and_fill_one_row_a_replay(cuda_device, no_records):
    """The default configuration over 48 sweeps with the flag on and off:
    the same poses and map sizes bit for bit; off, no record; on, one row
    a replay, every stamp written, the stages in order inside the replay
    and their sum at most the graph's, the clock's bracket under 100 us."""
    seq = make_tunnel_sequence(num_scans=48, azimuth_steps=900, step=0.35, seed=0)
    on_cfg = cfg_mod.LocusConfig()
    off_cfg = dataclasses.replace(on_cfg, b_enable_computation_time_profiling=False)
    poses_off, sizes_off, recs_off = _replay(off_cfg, seq, cuda_device)
    poses_on, sizes_on, recs_on = _replay(on_cfg, seq, cuda_device)
    np.testing.assert_array_equal(poses_on, poses_off)
    np.testing.assert_array_equal(sizes_on, sizes_off)
    assert recs_off == []
    (rec,) = recs_on
    assert rec["replays"] == 48 and rec["device_ns"].shape == (48, 16) and rec["host_ns"].shape == (48, 3)
    assert rec["stages"] == list(STAGES)
    dev = rec["device_ns"]
    assert (dev > 0).all()
    assert (np.diff(dev, axis=1) >= 0).all()                    # head, the stages in order, tail
    assert (dev[1:, 0] >= dev[:-1, rec["tail_slot"]]).all()     # one replay after the other
    graph_ns = dev[:, rec["tail_slot"]] - dev[:, 0]
    stages_ns = sum(dev[:, b] - dev[:, a] for a, b in rec["stage_slots"])
    assert (stages_ns <= graph_ns).all()
    host = rec["host_ns"]
    assert (np.diff(host, axis=1) >= 0).all() and (host[1:, 0] >= host[:-1, 2]).all()
    assert 0 < rec["bracket_ns"] < 100_000
    # a replay's tail lies on the device's clock after its call began
    assert (dev[:, rec["tail_slot"]] >= host[:, 0] + rec["offset_ns"] - rec["bracket_ns"]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("flag", [True, False])
def test_the_graph_holds_stamp_nodes_only_with_the_flag(cuda_device, no_records, flag):
    """Under the profiler, a replay of the graph captured with the flag on
    runs 16 stamp kernels (head, tail, seven stages' entry and exit); with
    it off, none."""
    seq = make_tunnel_sequence(num_scans=3, azimuth_steps=256, step=0.3, seed=1)
    cfg = _small_cfg(b_enable_computation_time_profiling=flag)
    rstep = runner.make_replay_step(cfg)
    state = pipeline.init_state(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32))
    args = [runner.scan_inputs(seq, i, cfg, cuda_device) for i in range(3)]
    state, _ = rstep(state, *args[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a in args[1:]:
            state, _ = rstep(state, *a)
        torch.cuda.synchronize()
    stamps = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "stamp_kernel" in e.name]
    assert len(stamps) == (2 * 16 if flag else 0)
    assert len(graph.replay_records()) == (1 if flag else 0)


@pytest.mark.gpu
def test_a_stage_inside_a_gated_body_raises_at_capture(cuda_device, no_records):
    def fn(state, x):
        out = torch.zeros_like(x)

        def body():
            with graph.stage("stage_inside"):
                graph.assign(out, x + 1)

        graph.gate(x.sum() > 0, body, torch.zeros((), dtype=torch.int64, device=x.device))
        return state, out

    step = graph.CapturedStep(fn, "test.gated_stage", stamps=True)
    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError, match="stage_inside"):
        step((torch.zeros(1, device=cuda_device),), x)
    assert graph.replay_records() == []
