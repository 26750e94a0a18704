"""The plain reference stands apart from the program, follows only the
path it implements, and agrees with the program's CPU step on a tiny
sequence."""
from __future__ import annotations

import ast
import copy
import json
import re
import subprocess
import sys

import pytest

from bench_helpers import BENCH, ROOT, SEED, tiny

PLAIN = {"__future__", "math", "dataclasses", "numpy", "torch"}
SIBLINGS = {p.stem for p in (BENCH / "reference").glob("*.py")}


def _imported(node) -> list:
    """The dotted names an import statement takes (`from reference import
    x` takes `reference.x`)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        assert node.level == 0, "a reference is loaded by path: no relative import"
        if node.module == "reference":
            return [f"reference.{a.name}" for a in node.names]
        return [node.module]
    return []


def test_the_reference_imports_nothing_of_the_program():
    """A reference file imports plain libraries and its siblings under
    reference/ (`reference.<sibling>`), nothing else."""
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            for name in _imported(node):
                parts = name.split(".")
                sibling = parts[0] == "reference" and len(parts) > 1 and parts[1] in SIBLINGS
                assert parts[0] in PLAIN or sibling, (path.name, name)
    code = ("import sys, json; sys.path[:0] = [%r]\n%s\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))") % (
        str(BENCH), "\n".join(f"import reference.{stem}" for stem in sorted(SIBLINGS)))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & {"locus_tpu_torch", "locus_tpu", "jax", "jaxlib", "flax", "harness"}


def _conf(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


_GONE = object()     # a key left out of the configuration


def _set(tree: dict, key: str, value) -> dict:
    out = copy.deepcopy(tree)
    *head, last = key.split(".")
    node = out
    for part in head:
        node = node[part]
    if value is _GONE:
        del node[last]
    else:
        node[last] = value
    return out


# (configuration, key, a value the reference does not follow): one case a
# setting that leaves locus_ref's path
REFUSED = [
    ("spot", "odometry.registration_method", "ndt"),
    ("spot", "localization.registration.registration_method", "ndt"),
    ("spot", "odometry.covariance_mode", "recompute"),
    ("spot", "localization.registration.covariance_mode", "adaptive"),
    ("spot", "odometry.recompute_covariances", True),
    ("spot", "localization.registration.recompute_covariances", True),
    ("spot", "odometry.transform_thresholding", False),
    ("spot", "localization.registration.transform_thresholding", False),
    ("spot", "filtering.normals_method", "knn"),
    ("spot", "filtering.extract_features", True),
    ("spot", "filtering.random_filter", True),
    ("spot", "filtering.grid_filter", True),
    ("spot", "filtering.outlier_filter", True),
    ("spot", "filtering.radius_filter", True),
    ("spot", "mapper.structure", "voxel_hash"),
    ("spot", "mapper.keyframe_at_map_resolution", True),
    ("spot", "fusion.data_integration_mode", 0),
    ("spot", "fusion.data_integration_mode", 2),
    ("spot", "fusion.b_convert_imu_to_base_link_frame", True),
    ("husky", "merger.b_use_random_filter", True),
    ("husky", "merger.b_use_radius_filter", True),
    ("spot", "b_monitor_space", True),
    ("spot", "b_is_flat_ground_assumption", True),
    ("spot", "b_add_keyframes_enabled", False),
    ("spot", "b_run_with_gt_point_cloud", True),
    ("husky", "fusion.b_integrate_interpolated_odom", True),
    ("spot", "mapper.structure", _GONE),
]


@pytest.mark.parametrize("conf, key, value", REFUSED,
                         ids=[f"{c}-{k}={'unstated' if v is _GONE else v}" for c, k, v in REFUSED])
def test_locus_ref_refuses_a_setting_off_its_path(conf, key, value):
    import numpy as np

    from reference import locus_ref

    locus = _set(_conf(conf)["locus"], key, value)
    with pytest.raises(ValueError, match=re.escape(f"locus.{key}")):
        locus_ref.Reference(locus, np.eye(4)[None], np.eye(4), "cpu")


def test_every_key_of_the_path_has_a_refused_case():
    from reference import locus_ref

    assert set(locus_ref.Reference.PATH) <= {k for _, k, _ in REFUSED}


@pytest.mark.parametrize("conf", ["spot", "husky", "spot_fleet4"])
def test_locus_ref_accepts_the_configurations_as_they_are(conf):
    import numpy as np

    from reference import locus_ref

    locus = _conf(conf)["locus"]
    ref = locus_ref.Reference(locus, np.eye(4)[None], np.eye(4), "cpu")
    assert ref.s.leaf == locus["filtering"]["grid_res"]


def _tiny_robot(cell: str):
    import torch

    from harness import cells

    c = cells.deep_merge(cells.cell(ROOT, cells.load(ROOT), cell), tiny(cell))
    robots = cells.driver(ROOT, c["traffic"]["driver"]).traffic(c["config"], c["traffic"], SEED, 0.1,
                                                               torch.device("cpu"))
    return c["config"], robots


@pytest.mark.parametrize("cell", ["spot.replay", "husky.replay"])
def test_register_runs_scan_to_scan_then_scan_to_submap_on_every_sweep_after_the_first(monkeypatch, cell):
    from harness import generate
    from reference import locus_ref

    conf, (sw,) = _tiny_robot(cell)
    calls = []
    register = locus_ref.Reference.register

    def counted(self, src, src_n, tgt, tgt_n, guess, reg):
        stage = "s2s" if reg is self.c["odometry"] else "s2m" if reg is self.c["localization"]["registration"] else None
        calls.append((self.s.scan_count, stage))
        return register(self, src, src_n, tgt, tgt_n, guess, reg)

    monkeypatch.setattr(locus_ref.Reference, "register", counted)
    locus_ref.replay(conf["locus"], generate.extrinsics(conf["sensor"]), sw.xyz, sw.valid, sw.stamps, sw.gt[0],
                     (sw.imu_stamps, sw.imu_quats), (sw.odom_stamps, sw.odom_poses), "cpu")
    n = len(sw.stamps)
    assert n > 2
    assert calls == [(i, stage) for i in range(1, n) for stage in ("s2s", "s2m")]


def test_the_check_refuses_ndt_without_a_reference_of_its_own():
    """A configuration that registers by NDT and names no reference fails
    at the check, naming the key: it is not judged against GICP."""
    import torch

    from harness import check

    conf, robots = _tiny_robot("spot.replay")
    conf = _set(conf, "locus.odometry.registration_method", "ndt")
    conf = _set(conf, "locus.localization.registration.registration_method", "ndt")
    with pytest.raises(ValueError, match=re.escape("locus.odometry.registration_method='ndt'")):
        check.reference(ROOT, conf, robots, torch.device("cpu"))


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
