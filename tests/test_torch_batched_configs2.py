"""The port's batched step (ROADMAP A15b) against each robot's single
replay, bit for bit, and against JAX's make_batched_replay within 1e-2 m
/ 1e-2 rad (the cases and their tolerances: tests/torch_batched_cases.py):
keyframes at map resolution, the grid + random + outlier + radius filters
(against the single replay only: the random draw is torch's), kNN normals
with the recompute covariance mode, the space monitor, and the stacked
ground-truth-map bootstrap. The other configurations:
test_torch_batched_configs.py.
"""
import pytest

from tests.torch_batched_cases import NO_JAX, check_matches_jax, check_matches_single, write_gt_pcd

CONFIGS = ["keyframe_at_map_resolution", "filters", "knn_recompute", "space_monitor", "gt_map"]


@pytest.fixture(scope="module")
def gt_pcd(tmp_path_factory):
    return write_gt_pcd(tmp_path_factory)


@pytest.mark.parametrize("name", CONFIGS)
def test_batched_config_matches_single(name, gt_pcd):
    check_matches_single(name, gt_pcd)


@pytest.mark.parametrize("name", [c for c in CONFIGS if c not in NO_JAX])
def test_batched_config_matches_jax(name, gt_pcd):
    check_matches_jax(name, gt_pcd)
