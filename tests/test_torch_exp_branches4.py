"""The ablated config branches of the replay experiments against the JAX
package (tests/torch_exp_cases.py): keyframes and the MSW refresh off,
which leave the map empty, so that the ANN and the scan-to-submap GICP
run over a map with no point on every scan."""
from tests import torch_exp_cases as cases


def test_empty_map_branch_matches_jax():
    _, sizes, counts = cases.check_case("no_keyframes_no_msw")
    assert (sizes == 0).all(), sizes
    # no correspondence: the scan-to-submap loop stops after one trip
    assert all(loc == (1, 1) for _, loc in counts), counts
