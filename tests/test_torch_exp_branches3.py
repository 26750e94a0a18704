"""The ablated config branches of the replay experiments against the JAX
package (tests/torch_exp_cases.py): no ICP covariance (no Ap, no 6x6
Jacobi in the scan-to-submap update), and the MSW refresh off."""
import pytest

from tests import torch_exp_cases as cases


@pytest.mark.parametrize("name", ["no_icp_covariance", "no_msw"])
def test_branch_matches_jax(name):
    _, sizes, _ = cases.check_case(name)
    assert sizes[-1] > 0, sizes
