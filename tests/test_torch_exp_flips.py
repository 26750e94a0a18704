"""The two reasons that tests/torch_exp_cases.py accepts for an
outer-iteration count that differs between the port and the JAX package,
each shown with its counts on a scan where it holds, each package
stepping once from JAX's state before it:

- scan 11's scan-to-scan GICP (small_cfg): JAX's compiled step takes 4
  trips, the same step run op by op (`jax.disable_jit`) takes 3, as the
  port does: the count turns on XLA's rounding of one program;
- scan 7's scan-to-submap GICP with 2 inner steps: JAX's compiled step
  runs to the cap of 20 trips, op by op it converges in 6, as the port
  does;
- scan 9's scan-to-submap GICP (small_cfg, 5 trips in the port, 7 in
  JAX): it starts from the scan-to-scan result, and on JAX's own
  preprocessed clouds JAX's f32 result lies more than 1e-4 m from a
  float64 run of the same registration while the port's lies within
  1e-5 m of it (tools/torch_parity.py's `preprocess_stage`): the two
  loops start from priors that JAX's rounding set apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from locus_tpu import runner as jrunner
from locus_tpu_torch import runner as trunner
from locus_tpu_torch.convert import config_from_dict, state_from_numpy
from tests import torch_exp_cases as cases
from tests.test_pipeline import small_cfg
from tests.torch_helpers import load_tool

def _before(jcfg, scan):
    """(config, JAX's jitted step, JAX's state before `scan`, the port's
    config, scan `scan`'s inputs as torch tensors)."""
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    seq = cases.tunnel()
    tseq = cases.port_seq(seq)
    rstep = jrunner.make_replay_step(jcfg)
    jst = cases.jax_state(jcfg, seq)
    for i in range(scan):
        jst, _ = rstep(jst, *[jnp.asarray(a.numpy()) for a in trunner.scan_inputs(tseq, i, tcfg, "cpu")])
    return rstep, jst, tcfg, trunner.scan_inputs(tseq, scan, tcfg, "cpu")


def _copy(jst):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jst)


@pytest.mark.parametrize("case, scan, stage, counts", [
    ("default", 11, "odom_iterations", (4, 3)),
    ("inner_iterations_2", 7, "loc_iterations", (20, 6)),
])
def test_count_turns_on_jax_rounding(case, scan, stage, counts):
    jcfg = small_cfg() if case == "default" else cases.CASES[case](small_cfg())
    rstep, jst, tcfg, args = _before(jcfg, scan)
    _, tout = trunner.replay_step(state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu"), *args, cfg=tcfg)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    _, compiled = rstep(_copy(jst), *jargs)
    with jax.disable_jit():
        _, op_by_op = rstep(_copy(jst), *jargs)
    assert (int(getattr(compiled, stage)), int(getattr(op_by_op, stage))) == counts
    assert int(getattr(tout, stage)) == counts[1]


def test_scan_9_starts_from_jax_rounding():
    parity = load_tool("torch_parity")
    jcfg = small_cfg()
    rstep, jst, tcfg, args = _before(jcfg, 9)
    before = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    stages = parity.preprocess_stage(jcfg, tcfg, jst, before, args)
    _, tout = trunner.replay_step(before, *args, cfg=tcfg)
    jst, jout = rstep(jst, *[jnp.asarray(a.numpy()) for a in args])
    port_f64 = stages["_port_gicp_float64"]
    jax_off = float(np.linalg.norm(np.asarray(jst.odom.incremental)[:3, 3] - port_f64[:3, 3]))
    port_off = float(np.linalg.norm(stages["_port_gicp_on_jax"][:3, 3] - port_f64[:3, 3]))
    assert jax_off > cases.F32_OFF_M and port_off < cases.F64_ON_M, (jax_off, port_off)
    assert (int(tout.loc_iterations), int(jout.loc_iterations)) == (5, 7)
