"""The port's multi-lidar merger (`locus_tpu_torch/merger.py`) against the
JAX package's: the four cases of tests/test_merger.py, then three
raycast lidars at the extrinsics of configs/husky_sensors.yaml merged by
both packages for every alive pattern, with the passthrough on and off.
Merged coordinates within 1e-6 m plus one f32 rounding step of the
coordinate (XYZ_RTOL: each package applies one f32 rigid transform, and
the two sum the rotation's three products in another order, so points
beyond 16 m, where a step exceeds 1e-6 m, may part by a step), masks
equal. The random filter draws from torch's generator, not the JAX PRNG,
so its case checks the law (the kept share), not the draw."""
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import merger as jmerger
from locus_tpu.config import MergerConfig as JMergerConfig
from locus_tpu.core.cloud import PointCloud as JCloud
from locus_tpu.io import synthetic
from locus_tpu_torch import merger
from locus_tpu_torch.config import MergerConfig
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.io import sensors
from tests.torch_helpers import np_

XYZ_TOL_M = 1e-6
XYZ_RTOL = float(np.finfo(np.float32).eps)
HUSKY = str(Path(__file__).resolve().parent.parent / "configs" / "husky_sensors.yaml")


def cloudy(pts, capacity=8, mask=None):
    return PointCloud.from_points(np.asarray(pts, np.float32), capacity=capacity, mask=mask, device="cpu")


def translation(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = x
    return T


def test_merge_applies_extrinsics():
    a = cloudy([[1, 0, 0]])
    b = cloudy([[0, 1, 0]])
    out = merger.merge([a, b], [np.eye(4, dtype=np.float32), translation(10.0)], alive=torch.tensor([True, True]),
                       cfg=MergerConfig(number_of_velodynes=2))
    xyz = np_(out.xyz)[np_(out.mask)]
    assert xyz.shape[0] == 2
    assert any(np.allclose(p, [10, 1, 0], atol=1e-5) for p in xyz)


def test_failover_masks_dead_lidar():
    a = cloudy([[1, 0, 0], [2, 0, 0]])
    b = cloudy([[0, 1, 0], [0, 2, 0]])
    eye = np.eye(4, dtype=np.float32)
    out = merger.merge([a, b], [eye, eye], alive=torch.tensor([True, False]), cfg=MergerConfig(number_of_velodynes=2))
    xyz = np_(out.xyz)[np_(out.mask)]
    assert xyz.shape[0] == 2
    assert np.all(xyz[:, 1] == 0)  # only lidar a's points survive


def test_health_timeouts_and_resurrection():
    st, jst = merger.init_state(3, device="cpu"), jmerger.init_state(3)
    steps = [("observe", 0, 10.0), ("observe", 1, 10.0), ("health", 10.5, [True, True, False]),
             ("health", 12.0, [False, False, False]),                      # lidar 1 dies
             ("observe", 1, 12.1), ("health", 12.2, [False, True, False])]  # resurrection
    for kind, *args in steps:
        if kind == "observe":
            st, jst = merger.observe(st, *args), jmerger.observe(jst, *args)
            np.testing.assert_array_equal(np_(st.last_reception), np_(jst.last_reception))
            np.testing.assert_array_equal(np_(st.alive), np_(jst.alive))
        else:
            now, expected = args
            h = np_(merger.health(st, now=now, timeout=1.0))
            np.testing.assert_array_equal(h, expected)
            np.testing.assert_array_equal(h, np_(jmerger.health(jst, now=now, timeout=1.0)))


def _observe_by_indexing(state, lidar_index, stamp):
    """`observe` as an indexed write of the Python number: the reference for
    the bits it stores."""
    last, alive = state.last_reception.clone(), state.alive.clone()
    last[lidar_index] = stamp
    alive[lidar_index] = True
    return merger.MergerState(last, alive)


@pytest.mark.parametrize("stamp", [12345.678901, 1.7e9 + 0.123456, 0.1, np.float64(1698765432.987654)],
                         ids=["hours", "epoch", "tenth", "np_epoch"])
@pytest.mark.parametrize("lidar", [0, 1, 2])
def test_observe_stores_the_indexed_writes_bits(lidar, stamp):
    """observe writes the stamp without staging it through a host tensor;
    it stores the f32 bits the indexed write stores (stamps that f32 must
    round), leaves the state it is given unchanged, and health reads the
    same flags from it."""
    state = merger.observe(merger.init_state(3, device="cpu"), (lidar + 1) % 3, 12345.0)
    before = [x.clone() for x in state]
    got, ref = merger.observe(state, lidar, stamp), _observe_by_indexing(state, lidar, stamp)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.device == b.device
    np.testing.assert_array_equal(np_(got.last_reception).view(np.int32), np_(ref.last_reception).view(np.int32))
    np.testing.assert_array_equal(np_(got.alive), np_(ref.alive))
    for a, b in zip(state, before):
        np.testing.assert_array_equal(np_(a), np_(b))
    for now in (float(stamp) + 0.5, float(stamp) + 2.0, 12345.5):
        np.testing.assert_array_equal(np_(merger.health(got, now)), np_(merger.health(ref, now)))


def test_merge_capacity():
    a = cloudy(np.random.default_rng(0).normal(size=(5, 3)))
    b = cloudy(np.random.default_rng(1).normal(size=(5, 3)))
    eye = np.eye(4, dtype=np.float32)
    out = merger.merge([a, b], [eye, eye], alive=torch.tensor([True, True]), capacity=12,
                       cfg=MergerConfig(number_of_velodynes=2))
    assert out.capacity == 12
    assert int(out.count()) == 10
    with pytest.raises(ValueError, match="number_of_velodynes"):
        merger.merge([a, b], [eye, eye], alive=torch.tensor([True, True]), cfg=MergerConfig(number_of_velodynes=3))


@pytest.fixture(scope="module")
def husky_scans():
    """One raycast scan of each Husky lidar in the tunnel, in its sensor
    frame, with the lidar's extrinsics."""
    lidars, _ = sensors.load_sensor_extrinsics(HUSKY)
    world = synthetic.BoxWorld.default_tunnel(length=30.0)
    base = np.eye(4)
    base[:3, 3] = [0.5, 0.2, 0.0]
    scans = []
    for k, T in enumerate(lidars.values()):
        pts, valid = synthetic.simulate_scan(world, base @ T.astype(np.float64), azimuth_steps=96, seed=k)
        scans.append((pts, valid, T))
    return scans


@pytest.mark.parametrize("passthrough", [True, False])
@pytest.mark.parametrize("alive", list(itertools.product([True, False], repeat=3)),
                         ids=lambda a: "".join("1" if x else "0" for x in a))
def test_merge_matches_jax(husky_scans, passthrough, alive):
    # a 0.4 m limit cuts the upper beams of the tilted side lidars
    limit = 0.4 if passthrough else 100.0
    kw = dict(number_of_velodynes=3, b_use_passthrough=passthrough, passthrough_limit=limit)
    cap = 2048
    clouds = [cloudy(p, capacity=cap, mask=v) for p, v, _ in husky_scans]
    jclouds = [JCloud.from_points(p, capacity=cap, mask=jnp.asarray(v)) for p, v, _ in husky_scans]
    ext = [T for _, _, T in husky_scans]
    out = merger.merge(clouds, ext, torch.tensor(alive), MergerConfig(**kw), capacity=3 * 2048)
    ref = jmerger.merge(jclouds, ext, jnp.asarray(alive), JMergerConfig(**kw), capacity=3 * 2048)
    mask = np_(out.mask)
    np.testing.assert_array_equal(mask, np_(ref.mask))
    np.testing.assert_allclose(np_(out.xyz)[mask], np_(ref.xyz)[mask], atol=XYZ_TOL_M, rtol=XYZ_RTOL)
    np.testing.assert_array_equal(np_(out.xyz)[~mask], np_(ref.xyz)[~mask])   # the sentinel
    per_lidar = [int(v.sum()) for _, v, _ in husky_scans]
    if not passthrough:
        assert int(mask.sum()) == sum(n for n, a in zip(per_lidar, alive) if a)
    elif alive[1]:
        assert int(mask.sum()) < sum(n for n, a in zip(per_lidar, alive) if a)


def test_merge_random_filter_keeps_its_share(husky_scans):
    """The random filter after the merge: about 1 - decimate_percentage of
    the merged points kept, the same law as the JAX package's."""
    clouds = [cloudy(p, capacity=2048, mask=v) for p, v, _ in husky_scans]
    cfg = MergerConfig(number_of_velodynes=3, b_use_random_filter=True, decimate_percentage=0.7)
    full = merger.merge(clouds, [T for *_, T in husky_scans], torch.tensor([True] * 3),
                        MergerConfig(number_of_velodynes=3), capacity=3 * 2048)
    out = merger.merge(clouds, [T for *_, T in husky_scans], torch.tensor([True] * 3), cfg,
                       generator=torch.Generator().manual_seed(5), capacity=3 * 2048)
    n, kept = int(full.count()), int(out.count())
    assert np.all(np_(full.mask)[np_(out.mask)])          # only merged points are kept
    sd = np.sqrt(n * 0.3 * 0.7)
    assert abs(kept - 0.3 * n) < 5 * sd, (kept, n)
    again = merger.merge(clouds, [T for *_, T in husky_scans], torch.tensor([True] * 3), cfg,
                         generator=torch.Generator().manual_seed(5), capacity=3 * 2048)
    np.testing.assert_array_equal(np_(again.mask), np_(out.mask))   # one seed, one draw
