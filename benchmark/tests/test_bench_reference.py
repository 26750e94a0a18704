"""The plain reference stands apart from the program, and agrees with the
program's CPU step on a tiny sequence."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from bench_helpers import BENCH, ROOT, SEED, tiny

PLAIN = {"__future__", "math", "dataclasses", "numpy", "torch"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= PLAIN, (path.name, tops)
    code = ("import sys, json; sys.path[:0] = [%r]\nimport reference.locus_ref\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))") % str(BENCH)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & {"locus_tpu_torch", "locus_tpu", "jax", "jaxlib", "flax", "harness"}


@pytest.mark.parametrize("cell, step_limit_m", [("spot.replay", 0.02), ("husky.replay", 0.02)])
def test_the_reference_and_the_ports_cpu_step_agree(cell, step_limit_m):
    """Every decision agrees at this size (leaf, points, keyframes), so the
    motions from sweep to sweep differ by rounding and the solvers' own
    tolerances: a few mm. 2 cm is what the full-size cells read at most
    (PERF.md), and a step that is not taken is 0.1 m or more."""
    import run

    result, _ = run.run_cell(ROOT, cell, SEED, 0.1, False, device="cpu", overrides=tiny(cell))
    check = result["check"]
    assert check["step_gap_m"]["value"] < step_limit_m, check
    assert check["map_size_gap"]["value"] < 0.05, check
