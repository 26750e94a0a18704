"""The ablated config branches of the replay experiments against the JAX
package, two cases a file (tests/torch_exp_cases.py has the cases, the
tolerances and the named count flips): a zero-trip scan-to-scan loop
(odometry iterations 0) and a zero-trip scan-to-submap loop (its final
re-lookup at identity)."""
import pytest

from tests import torch_exp_cases as cases


@pytest.mark.parametrize("name", ["odometry_iterations_0", "localization_iterations_0"])
def test_branch_matches_jax(name):
    _, _, counts = cases.check_case(name)
    stage = 0 if name.startswith("odometry") else 1
    assert all(per_stage[stage] == (0, 0) for per_stage in counts), counts
