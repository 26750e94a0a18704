"""The ablated config branches of the replay experiments against the JAX
package (tests/torch_exp_cases.py): both stages capped at 4 outer
iterations, and 2 inner Gauss-Newton steps in both stages."""
import pytest

from tests import torch_exp_cases as cases


@pytest.mark.parametrize("name", ["iterations_4", "inner_iterations_2"])
def test_branch_matches_jax(name):
    jcfg, _, counts = cases.check_case(name)
    cap = jcfg.localization.registration.iterations
    assert all(t <= cap and j <= cap for per_stage in counts for t, j in per_stage), counts
