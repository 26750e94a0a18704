"""The comparison that decides `correct` can fail: the control (the
reference at bfloat16 in the program's place) and runs whose timed path
is broken underneath all come out not correct, while the same run unbroken
comes out correct."""
from __future__ import annotations

import pytest

from bench_helpers import ROOT, SEED, tiny

CELLS = ("spot.replay", "husky.replay")
SECONDS = 0.1    # one tiny pass of 8 sweeps


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    import control

    rec = control.control(ROOT, cell, SEED, SECONDS, device="cpu", overrides=tiny(cell))
    assert rec["correct"] is False, rec


def _state_unchanged(step):
    """A step that computes, and returns its input state."""
    def broken(state, raw, stamp, cfg, seq=None):
        _, out = step(state, raw, stamp, cfg, seq=seq)
        return state, out
    return broken


def _answer_altered(step):
    """A step whose pose of sweep 3 comes out moved by 0.5 m."""
    def broken(state, raw, stamp, cfg, seq=None):
        new, out = step(state, raw, stamp, cfg, seq=seq)
        if int(seq) == 3:
            pose = out.pose.clone()
            pose[..., 0, 3] += 0.5
            out = out._replace(pose=pose)
        return new, out
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, _state_unchanged, _answer_altered])
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault):
    import run
    from locus_tpu_torch import pipeline

    over = tiny(cell)
    if fault is _state_unchanged:
        # a robot left standing parts from the reference by its own motion
        # alone: 20 sweeps take spot 3.0 m, past its pose limit of 2 m
        over["traffic"]["sweeps_per_pass"] = 20
    if fault is not None:
        monkeypatch.setattr(pipeline, "step", fault(pipeline.step))
    result, _ = run.run_cell(ROOT, cell, SEED, SECONDS, False, device="cpu", overrides=over)
    assert result["correct"] is (fault is None), result["check"]
    if fault is not None:
        assert result["failed"] > 0
