"""The config branches that the replay experiments (tools/torch_exp_*.py)
ablate, held against the JAX package on tests/test_torch_pipeline.py's
12-scan tunnel under tests.test_pipeline.small_cfg; shared by
tests/test_torch_exp_branches*.py (split so that no file takes more than
about two minutes on one worker).

Each case changes small_cfg as one JAX tool's `dc.replace` chain does
and checks two things:

- the chained replay, JAX's `runner.make_scan_replay` (XLA on the CPU)
  against the port's (plain PyTorch): every pose within 1e-2 m and 1e-2
  rad (the tolerance of test_torch_pipeline.py) and every map size within
  0.5 %;
- the outer-iteration counts of both registration stages on every scan,
  exactly, each package stepping once from JAX's state before that scan
  (JAX's `make_replay_step`, the state converted by
  `convert.state_from_numpy`). Chained, the two replays part by f32
  noise (at most a few mm here) and the scan-to-submap loop, which often
  ends on its cap or on a step near the threshold, turns that into other
  counts on later scans: the chained lists of the default config differ
  on 6 of 12 scans while the one-step counts differ on 2
  (`tools/torch_parity.py --iterations` and `--steps`).

Where a one-step count differs, the case must show why on that scan,
from the same state:

- `op_by_op`: JAX's same step run op by op (`jax.disable_jit`) takes the
  port's count: the count turns on XLA's rounding of the compiled
  program;
- `f32_prior` (scan-to-submap only): on JAX's own preprocessed clouds,
  JAX's f32 scan-to-scan result lies more than F32_OFF_M from a float64
  run of the same registration while the port's lies within F64_ON_M of
  it (tools/torch_parity.py's `preprocess_stage`): the two loops start
  from priors that JAX's rounding set apart.

A difference with neither reason fails the case.
tests/test_torch_exp_flips.py shows each reason on a scan of its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from locus_tpu import pipeline as jpl
from locus_tpu import runner as jrunner
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu_torch import pipeline as tpl
from locus_tpu_torch import runner as trunner
from locus_tpu_torch.convert import config_from_dict, state_from_numpy
from locus_tpu_torch.io.dataset import Sequence as TSequence
from tests.test_pipeline import small_cfg
from tests.torch_helpers import load_tool, pose_diff

SCANS = 12
POSE_TOL_M = 1e-2
POSE_TOL_RAD = 1e-2
MAP_SIZE_RTOL = 5e-3
R = dataclasses.replace

F32_OFF_M = 1e-4      # JAX's f32 scan-to-scan result from the float64 one, at least
F64_ON_M = 1e-5       # the port's, at most


def _both_stages(cfg, **kw):
    return cfg.replace(odometry=R(cfg.odometry, **kw),
                       localization=R(cfg.localization, registration=R(cfg.localization.registration, **kw)))


# name: small_cfg changed as the JAX tools' chains change it
CASES = {
    # tools/exp_ablate.py:43-45 (s2s_0iter)
    "odometry_iterations_0": lambda c: c.replace(odometry=R(c.odometry, iterations=0)),
    # tools/exp_ablate.py:46-53 (s2m_0iter)
    "localization_iterations_0": lambda c: c.replace(
        localization=R(c.localization, registration=R(c.localization.registration, iterations=0))),
    # tools/exp_gap.py:120-128 (iter_cap_4)
    "iterations_4": lambda c: _both_stages(c, iterations=4),
    # tools/exp_gap.py:129-137 (inner_2), exp_inner.py:47-56
    "inner_iterations_2": lambda c: _both_stages(c, inner_iterations=2),
    # tools/exp_ablate.py:40-42 (no_cov)
    "no_icp_covariance": lambda c: c.replace(localization=R(c.localization, compute_icp_covariance=False)),
    # tools/exp_gap2.py:106-108 (warm_no_msw_gate)
    "no_msw": lambda c: c.replace(mapper=R(c.mapper, b_enable_msw=False)),
    # tools/exp_ablate.py:36-39 (no_kf_msw): the map stays empty
    "no_keyframes_no_msw": lambda c: c.replace(b_add_keyframes_enabled=False, mapper=R(c.mapper, b_enable_msw=False)),
}


def tunnel():
    return make_tunnel_sequence(num_scans=SCANS, azimuth_steps=256, step=0.3, seed=1)


def port_seq(seq):
    return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})


def jax_state(cfg, seq):
    st = jpl.init_state(cfg, initial_pose=jnp.asarray(seq.gt_poses[0], jnp.float32))
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), st)     # the replays donate it


def copy_jax(jst):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jst)


def port_state(jst):
    """The port's copy of a JAX state, on the CPU."""
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")


def why_counts_differ(jcfg, tcfg, rstep, before, after, args, stage, port_count):
    """Why the port's `stage` count ("odom_iterations" or
    "loc_iterations") on a scan differs from JAX's compiled step's, stepping
    from JAX's state `before` to `after` on the scan's inputs `args`:
    "op_by_op", "f32_prior" (see the module's docstring), or None."""
    jargs = [jnp.asarray(a.numpy()) for a in args]
    with jax.disable_jit():
        _, op_by_op = rstep(copy_jax(before), *jargs)
    if int(getattr(op_by_op, stage)) == port_count:
        return "op_by_op"
    if stage == "loc_iterations":
        stages = load_tool("torch_parity").preprocess_stage(jcfg, tcfg, before, port_state(before), args)
        f64 = stages["_port_gicp_float64"][:3, 3]
        jax_off = float(np.linalg.norm(np.asarray(after.odom.incremental)[:3, 3] - f64))
        port_off = float(np.linalg.norm(stages["_port_gicp_on_jax"][:3, 3] - f64))
        if jax_off > F32_OFF_M and port_off < F64_ON_M:
            return "f32_prior"
    return None


def one_step_counts(jcfg, seq, tcfg, tseq, scans=SCANS):
    """Per scan, ((port odom, JAX odom), (port loc, JAX loc)) outer
    iterations, each package stepping once from JAX's state, and
    {(stage, scan): reason} for every count that differs (the reason None
    where `why_counts_differ` finds none)."""
    rstep = jrunner.make_replay_step(jcfg)
    jst = jax_state(jcfg, seq)
    counts, reasons = [], {}
    for i in range(scans):
        args = trunner.scan_inputs(tseq, i, tcfg, "cpu")
        before = copy_jax(jst)                      # the compiled step donates its state
        _, tout = trunner.replay_step(port_state(before), *args, cfg=tcfg)
        jst, jout = rstep(jst, *[jnp.asarray(a.numpy()) for a in args])
        counts.append(((int(tout.odom_iterations), int(jout.odom_iterations)),
                       (int(tout.loc_iterations), int(jout.loc_iterations))))
        for stage, (port, jax_) in zip(("odom_iterations", "loc_iterations"), counts[-1]):
            if port != jax_:
                reasons[(stage, i)] = why_counts_differ(jcfg, tcfg, rstep, before, jst, args, stage, port)
    return counts, reasons


def check_case(name):
    jcfg = CASES[name](small_cfg())
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    seq = tunnel()
    tseq = port_seq(seq)
    # the chained replays
    _, (jp, _, jsizes) = jrunner.make_scan_replay(jcfg)(jax_state(jcfg, seq), jrunner.pack_sequence(seq, jcfg))
    tst = tpl.init_state(tcfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32), device="cpu")
    _, (tp, _, tsizes) = trunner.make_scan_replay(tcfg)(tst, trunner.pack_sequence(tseq, tcfg, device="cpu"))
    for i, (a, b) in enumerate(zip(tp.numpy(), np.asarray(jp))):
        dt, dr = pose_diff(a, b)
        assert dt < POSE_TOL_M and dr < POSE_TOL_RAD, (name, i, dt, dr)
    jsizes, tsizes = np.asarray(jsizes), tsizes.numpy()
    np.testing.assert_allclose(tsizes, jsizes, rtol=MAP_SIZE_RTOL, atol=0)
    # the one-step iteration counts
    counts, reasons = one_step_counts(jcfg, seq, tcfg, tseq)
    unexplained = [k for k, why in reasons.items() if why is None]
    assert not unexplained, (name, unexplained, counts)
    return jcfg, jsizes, counts
