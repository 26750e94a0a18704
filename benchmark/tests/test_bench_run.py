"""A run of the benchmark: its last line's keys, its refusal without a
card, and the modules it leaves loaded."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from bench_helpers import BENCH, ROOT, SEED, tiny

CELLS = ("spot.replay", "husky.replay")


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_the_contracts_keys(traced):
    import run

    result, lines = run.run_cell(ROOT, "spot.replay", SEED, 0.1, traced, device="cpu", overrides=tiny("spot.replay"))
    keys = {"correct", "attempted", "failed", "metrics", "device", "check"} | ({"breakdown"} if traced else set())
    assert set(result) == keys and list(result)[-1] == "check"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"scans_per_s", "setup_s"}
    assert all(line.startswith("check ") for line in lines[-4:])
    json.dumps(result)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "spot.replay", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_no_jax_module_is_loaded_after_a_run(cell):
    code = (
        "import sys, json; from pathlib import Path; sys.path[:0] = [%r, %r]\n"
        "from bench_helpers import SEED, tiny\n"
        "import run\n"
        "run.run_cell(Path(%r), %r, SEED, 0.1, False, device='cpu', overrides=tiny(%r))\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    ) % (str(BENCH / "tests"), str(BENCH), str(ROOT), cell, cell)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ("spot.replay", "husky.replay"))
def test_a_cell_on_the_card_is_correct(card, cell):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed", str(SEED),
                        "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
