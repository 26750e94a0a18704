"""The port's replay experiments (tools/torch_exp_*.py) against the JAX
package's (tools/exp_*.py), on the CPU:

(a) each tool's variant table equals the JAX tool's `dc.replace` chains,
    copied here with their file:line and applied to the JAX tools' base
    config: every field of every variant equal (through
    `convert.config_from_dict`), and the same fields changed from the
    base; the replay-body switches of exp_gap2 and exp_steady's windows
    equal the JAX tool's;
(c) exp_gap and exp_ablate run through `main` with --device cpu (bench.py's
    CI fallback config, small_cfg's size) for a few scans and one rep:
    each prints the JAX tool's keys, and the default variant's poses equal
    `runner.run_sequence`'s on the same scans bit for bit
    (tests/test_torch_exp_tools2.py has exp_gap2, exp_steady, exp_inner);
(d) examples/torch_quickstart.py runs on the CPU for a few scans.
A state copied by `_torch_tool.copy_state` shares no tensor with its
original, and `_torch_tool.interleaved` fails a timed replay whose poses
leave its untimed replay's.
"""
import dataclasses as dc
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from locus_tpu.config import FilterConfig, LocusConfig, MapperConfig
from locus_tpu_torch import pipeline as tpl
from locus_tpu_torch import runner as trunner
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from tests.torch_helpers import load_tool

ROOT = Path(__file__).resolve().parent.parent


def _cfg0():
    """The JAX tools' base config (tools/exp_gap.py:33-41, the same in
    exp_ablate.py:20-28, exp_gap2.py:30-38, exp_inner.py:37-45,
    exp_steady.py:19-27)."""
    return LocusConfig(
        scan_capacity=4096,
        raw_scan_capacity=32768,
        points_to_process_in_callback=3000,
        filtering=FilterConfig(normals_k=20),
        mapper=MapperConfig(
            map_capacity=1 << 17, keyframe_capacity=4096, map_voxel_leaf=0.15
        ),
    )


def _ablate_chains(base):
    """tools/exp_ablate.py:34-55."""
    return {
        "base": base,
        "no_kf_msw": base.replace(
            b_add_keyframes_enabled=False,
            mapper=dc.replace(base.mapper, b_enable_msw=False),
        ),
        "no_cov": base.replace(
            localization=dc.replace(base.localization, compute_icp_covariance=False)
        ),
        "s2s_0iter": base.replace(
            odometry=dc.replace(base.odometry, iterations=0)
        ),
        "s2m_0iter": base.replace(
            localization=dc.replace(
                base.localization,
                registration=dc.replace(
                    base.localization.registration, iterations=0
                ),
            )
        ),
        "no_adapt": base.replace(b_adaptive_input_voxelization=False),
    }


def _gap_chains(cfg0):
    """tools/exp_gap.py:105-144."""
    return {
        "default": cfg0,
        "no_keyframes": cfg0.replace(
            b_add_keyframes_enabled=False,
            mapper=dc.replace(cfg0.mapper, b_enable_msw=False),
        ),
        "iter_cap_8": cfg0.replace(
            odometry=dc.replace(cfg0.odometry, iterations=8),
            localization=dc.replace(
                cfg0.localization,
                registration=dc.replace(
                    cfg0.localization.registration, iterations=8
                ),
            ),
        ),
        "iter_cap_4": cfg0.replace(
            odometry=dc.replace(cfg0.odometry, iterations=4),
            localization=dc.replace(
                cfg0.localization,
                registration=dc.replace(
                    cfg0.localization.registration, iterations=4
                ),
            ),
        ),
        "inner_2": cfg0.replace(
            odometry=dc.replace(cfg0.odometry, inner_iterations=2),
            localization=dc.replace(
                cfg0.localization,
                registration=dc.replace(
                    cfg0.localization.registration, inner_iterations=2
                ),
            ),
        ),
        "no_cov": cfg0.replace(
            localization=dc.replace(
                cfg0.localization, compute_icp_covariance=False
            )
        ),
        "no_adaptive": cfg0.replace(b_adaptive_input_voxelization=False),
    }


def _gap2_chains(cfg0):
    """tools/exp_gap2.py:100-136: (config, replay-body switches)."""
    variants = {
        "warm_default": cfg0,
        "warm_no_kf": cfg0.replace(
            b_add_keyframes_enabled=False,
            mapper=dc.replace(cfg0.mapper, b_enable_msw=False),
        ),
        "warm_no_msw_gate": cfg0.replace(
            mapper=dc.replace(cfg0.mapper, b_enable_msw=False)
        ),
        "warm_no_cov": cfg0.replace(
            localization=dc.replace(cfg0.localization, compute_icp_covariance=False)
        ),
        "warm_inner2": cfg0.replace(
            odometry=dc.replace(cfg0.odometry, inner_iterations=2),
            localization=dc.replace(
                cfg0.localization,
                registration=dc.replace(
                    cfg0.localization.registration, inner_iterations=2
                ),
            ),
        ),
    }
    variants["warm_no_adaptive_leaf"] = cfg0.replace(
        b_adaptive_input_voxelization=False
    )
    variants["warm_fusion_none"] = cfg0.replace(
        fusion=dc.replace(cfg0.fusion, data_integration_mode=0)
    )
    mk_extra = {
        "warm_no_seq_stats": (cfg0, {"with_seq": False}),
        "warm_no_sensor_push": (
            cfg0.replace(fusion=dc.replace(cfg0.fusion, data_integration_mode=0)),
            {"with_sensors": False},
        ),
    }
    return {k: (v, {}) for k, v in variants.items()} | mk_extra


def _with_inner(cfg, n):
    """tools/exp_inner.py:47-56."""
    return cfg.replace(
        odometry=dc.replace(cfg.odometry, inner_iterations=n),
        localization=dc.replace(
            cfg.localization,
            registration=dc.replace(
                cfg.localization.registration, inner_iterations=n
            ),
        ),
    )


def _changed(a: dict, b: dict, prefix=""):
    """The dotted names of the fields where two asdict trees differ."""
    out = set()
    for k in a:
        if isinstance(a[k], dict):
            out |= _changed(a[k], b[k], f"{prefix}{k}.")
        elif a[k] != b[k]:
            out.add(prefix + k)
    return out


def _assert_same(port_cfg, jax_cfg, port_base, jax_base, name):
    port, jax_ = dc.asdict(port_cfg), dc.asdict(config_from_dict(dc.asdict(jax_cfg)))
    assert port == jax_, (name, _changed(port, jax_))
    assert _changed(port, dc.asdict(port_base)) == _changed(dc.asdict(jax_cfg), dc.asdict(jax_base)), name


@pytest.mark.parametrize("tool, chains", [("torch_exp_ablate", _ablate_chains), ("torch_exp_gap", _gap_chains)])
def test_variants_equal_the_jax_chains(tool, chains):
    t = load_tool(tool)
    base = t._torch_tool.production_config()
    assert dc.asdict(base) == dc.asdict(config_from_dict(dc.asdict(_cfg0())))
    jax_variants = chains(_cfg0())
    assert list(t.VARIANTS) == list(jax_variants)
    for name, change in t.VARIANTS.items():
        _assert_same(t._torch_tool.ablated(base, **change), jax_variants[name], base, _cfg0(), name)


def test_gap2_variants_and_bodies_equal_the_jax_chains():
    t = load_tool("torch_exp_gap2")
    base = t._torch_tool.production_config()
    jax_variants = _gap2_chains(_cfg0())
    assert list(t.VARIANTS) == list(jax_variants)
    for name, (change, body) in t.VARIANTS.items():
        jcfg, jbody = jax_variants[name]
        _assert_same(t._torch_tool.ablated(base, **change), jcfg, base, _cfg0(), name)
        assert body == jbody, name


def test_inner_settings_and_steady_windows_equal_the_jax_tools():
    inner = load_tool("torch_exp_inner")
    base = inner._torch_tool.production_config()
    assert inner.SETTINGS == {"inner3": 3, "inner2": 2}                   # exp_inner.py:69, :111
    for n in inner.SETTINGS.values():
        _assert_same(inner._torch_tool.ablated(base, inner_iterations=n), _with_inner(_cfg0(), n), base, _cfg0(), n)
    # exp_steady.py:61-78: (first scan, last scan + 1, after the 16-scan warm-up)
    windows = load_tool("torch_exp_steady").windows(144)
    assert {k: v[:3] for k, v in windows.items()} == {
        "fresh48": (0, 48, False), "steady32": (16, 48, True), "fresh144": (0, 144, False),
        "steady128": (16, 144, True)}


def test_copy_state_shares_no_tensor():
    tool = load_tool("_torch_tool")
    state = tpl.init_state(tool.fallback_config(), device="cpu")
    copy = tool.copy_state(state)

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for p in x for t in leaves(p)] if isinstance(x, tuple) else []

    pairs = list(zip(leaves(state), leaves(copy)))
    assert len(pairs) == len(leaves(state)) > 0
    for a, b in pairs:
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_interleaved_holds_every_timed_rep_to_its_untimed_replay():
    tool = load_tool("_torch_tool")
    dev = torch.device("cpu")
    shared = torch.zeros(2, 4, 4)

    def go(state, outs):             # a replay that changes its starting state in place
        state += 1.0
        return state.clone()

    with pytest.raises(RuntimeError, match="shared: timed rep 0 left its untimed replay's poses"):
        tool.interleaved({"shared": (2, lambda: shared, go)}, {"shared": 1}, dev)
    res = tool.interleaved({"copied": (2, lambda: tool.copy_state(shared), go)}, {"copied": 2}, dev)
    assert len(res["copied"]["rates"]) == 2
    np.testing.assert_array_equal(res["copied"]["poses"], shared.numpy() + 1.0)


def run_main(name, argv, monkeypatch, capsys):
    """tools/<name>.py's main with --device cpu and `argv`: its last
    printed line, parsed."""
    tool = load_tool(name)
    monkeypatch.setattr("sys.argv", [f"{name}.py", "--device", "cpu", *map(str, argv)])
    assert tool.main() == 0
    return tool, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def reference_poses(tool, seq, scans):
    """runner.run_sequence's poses of the first `scans` scans of `seq` at
    the experiments' CPU config."""
    poses, _, _ = trunner.run_sequence(seq, tool._torch_tool.fallback_config(), max_scans=scans, device="cpu")
    return poses


def assert_default_poses(tool, line, seq, scans):
    poses = np.asarray(line["default_poses"])
    assert poses.shape == (scans, 4, 4)
    np.testing.assert_array_equal(poses, reference_poses(tool, seq, scans))


def tunnel(scans):
    return make_tunnel_sequence(num_scans=scans, azimuth_steps=512, step=0.35, seed=0)


def test_exp_gap_main(monkeypatch, capsys):
    tool, line = run_main("torch_exp_gap", ["--scans", 3, "--reps", 1], monkeypatch, capsys)
    for k in ("odom_iters", "loc_iters", "kf_scans", "msw_scans", "mean_odom_iters", "mean_loc_iters"):
        assert k in line, k
    assert len(line["odom_iters"]) == len(line["loc_iters"]) == 3
    for name in tool.VARIANTS:
        row = line[name]
        assert row["scans_per_s"] == max(row["rates"]) and len(row["rates"]) == 1
        assert row["ms_per_scan"] == pytest.approx(1000.0 / row["scans_per_s"])
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert_default_poses(tool, line, tunnel(tool.SEQ_SCANS), 3)


def test_exp_ablate_main(monkeypatch, capsys):
    tool, line = run_main("torch_exp_ablate", ["--scans", 3, "--reps", 1], monkeypatch, capsys)
    for name in tool.VARIANTS:
        assert line[name] == line["rows"][name]["scans_per_s"] > 0
    assert line["warm_window"] == [0, 2] and line["timed_window"] == [1, 3]
    assert_default_poses(tool, line, tunnel(tool.SEQ_SCANS), 2)


def test_quickstart_runs_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "examples/torch_quickstart.py", "--device", "cpu", "--scans", "2"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = dict(line.split(":", 1) for line in r.stdout.strip().splitlines())
    assert list(lines) == ["rate", "ATE", "keyframes", "map points"]
    assert float(lines["ATE"].split()[0]) < 0.05
    assert int(lines["keyframes"]) >= 1 and int(lines["map points"]) > 0
