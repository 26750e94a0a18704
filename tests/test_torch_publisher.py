"""The port's host-side serving modules against the JAX package's:
`publisher.FixedRatePublisher` (the cases of
tests/test_publisher_interp.py; both fed the same stream, every published
stamp equal and every pose within 1e-12, numpy float64 on both sides),
the interpolated-odometry prior through the port's `fusion.push_odom`
(within 1e-6 of JAX's f32), and `diagnostics` (the cases of
tests/test_aux.py; records equal)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import diagnostics as jdiag
from locus_tpu import fusion as jf
from locus_tpu.config import FusionConfig
from locus_tpu.geometry import se3 as jse3
from locus_tpu.publisher import FixedRatePublisher as JPub
from locus_tpu_torch import config as tconfig
from locus_tpu_torch import diagnostics as tdiag
from locus_tpu_torch import fusion as tf
from locus_tpu_torch.publisher import FixedRatePublisher as TPub
from tests.torch_helpers import np_


def pose_x(x):
    T = np.eye(4)
    T[0, 3] = x
    return T


def _both_publishers(feed, **kw):
    """Run `feed(publisher)` on both; the published streams must agree."""
    j, t = JPub(**kw), TPub(**kw)
    feed(j)
    feed(t)
    assert [s for s, _ in t.published] == [s for s, _ in j.published]
    for (_, a), (_, b) in zip(t.published, j.published):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    return t


def test_fixed_rate_publisher_upsampling():
    def feed(pub):
        for i in range(51):
            pub.on_odom(i * 0.02, pose_x(i * 0.02))
        pub.on_scan_pose(0.0, pose_x(100.0))
        pub.run_until(0.55)

    pub = _both_publishers(feed, rate_hz=10.0)
    assert len(pub.published) == 5
    for t, p in pub.published:
        np.testing.assert_allclose(p[0, 3], 100.0 + t, atol=1e-6)


def test_publisher_dedup():
    def feed(pub):
        pub.on_scan_pose(0.0, pose_x(0.0))
        pub.tick(0.1)
        pub.tick(0.1)

    assert len(_both_publishers(feed, rate_hz=10.0).published) == 1


def test_publisher_without_odom_stream():
    def feed(pub):
        pub.on_scan_pose(0.0, pose_x(7.0))
        pub.run_until(0.3)

    pub = _both_publishers(feed, rate_hz=10.0)
    assert len(pub.published) == 3
    for _, p in pub.published:
        np.testing.assert_allclose(p[0, 3], 7.0)


def test_publisher_rotation_slerp_bounded():
    """Between odometry samples the upsampled orientation tracks the true
    constant-rate rotation (slerp, as the reference's tf2 lookup)."""
    rate = 0.5

    def feed(pub):
        for i in range(6):
            t = i * 0.2
            pub.on_odom(t, np.asarray(jse3.make_transform(jse3.so3_exp(jnp.asarray([0, 0, rate * t])), jnp.zeros(3)),
                                      np.float64))
        pub.on_scan_pose(0.0, np.eye(4))
        pub.run_until(0.95)

    pub = _both_publishers(feed, rate_hz=10.0)
    assert len(pub.published) == 9
    for t, p in pub.published:
        assert abs(np.arctan2(p[1, 0], p[0, 0]) - rate * t) < 5e-3


def test_publisher_sink_gets_covariance():
    got = []
    pub = TPub(rate_hz=10.0, sink=lambda t, p, c: got.append((t, c)))
    pub.on_scan_pose(0.0, pose_x(1.0), covariance=np.eye(6) * 0.5)
    pub.run_until(0.2)
    assert [t for t, _ in got] == pytest.approx([0.1, 0.2])
    np.testing.assert_array_equal(got[0][1], np.eye(6) * 0.5)


def _odom_states(cfg, samples):
    tcfg = tconfig.FusionConfig(**dataclasses.asdict(cfg))
    j, t = jf.init_state(cfg), tf.init_state(tcfg, device="cpu")
    for s, p in samples:
        j = jf.push_odom(j, s, p, wall_time=s)
        t = tf.push_odom(t, s, p, wall_time=s)
    return j, t, tcfg


def test_interpolated_odom_delta():
    j, t, _ = _odom_states(FusionConfig(b_integrate_interpolated_odom=True),
                           [(0.0, pose_x(0.0).astype(np.float32)), (0.2, pose_x(0.2).astype(np.float32))])
    jd, jok = jf.integrate_interpolated_odom(j, 0.05, 0.15)
    td, tok = tf.integrate_interpolated_odom(t, torch.tensor(0.05), torch.tensor(0.15))
    assert bool(tok) and bool(jok)
    np.testing.assert_allclose(np_(td), np_(jd), atol=1e-6)
    np.testing.assert_allclose(np_(td)[0, 3], 0.1, atol=1e-5)


def test_interpolated_odom_rotation_slerp():
    R1 = np.array(jse3.make_transform(jse3.so3_exp(jnp.asarray([0, 0, 0.4])), jnp.zeros(3)))
    j, t, _ = _odom_states(FusionConfig(b_integrate_interpolated_odom=True),
                           [(0.0, np.eye(4, dtype=np.float32)), (0.4, R1)])
    jd, _ = jf.integrate_interpolated_odom(j, 0.1, 0.3)
    td, ok = tf.integrate_interpolated_odom(t, torch.tensor(0.1), torch.tensor(0.3))
    assert bool(ok)
    np.testing.assert_allclose(np_(td), np_(jd), atol=1e-6)
    np.testing.assert_allclose(np.arctan2(np_(td)[1, 0], np_(td)[0, 0]), 0.2, atol=1e-3)


def test_interpolated_prior_in_cascade():
    cfg = FusionConfig(data_integration_mode=3, b_integrate_interpolated_odom=True)
    j, t, tcfg = _odom_states(cfg, [(s, pose_x(s).astype(np.float32)) for s in (0.0, 0.1, 0.2, 0.3)])
    jsel = jf.integrate_sensors(jf.integrate_sensors(j, 0.1, 0.3, cfg, prev_stamp=0.0).state, 0.25, 0.3, cfg,
                                prev_stamp=0.1)
    tsel = tf.integrate_sensors(tf.integrate_sensors(t, 0.1, 0.3, tcfg, prev_stamp=0.0).state, 0.25, 0.3, tcfg,
                                prev_stamp=0.1)
    assert int(tsel.source) == int(jsel.source) == tf.PRIOR_ODOM
    np.testing.assert_allclose(np_(tsel.prior), np_(jsel.prior), atol=1e-6)
    np.testing.assert_allclose(np_(tsel.prior)[:3, 3], [0.15, 0, 0], atol=1e-5)


class _Out:
    scan_to_scan_accepted = True
    scan_to_map_accepted = False
    map_size = 100
    xy_cross_section = 12.5


def test_diagnostics_from_output():
    jrec, trec = jdiag.from_step_output(1.0, _Out(), 3, 2), tdiag.from_step_output(1.0, _Out(), 3, 2)
    assert trec.to_dict() == jrec.to_dict()
    assert trec.level() == tdiag.WARN
    log = tdiag.DiagnosticsLog(window_s=5.0)
    log.add(trec)
    assert log.summary() == {"count": 1, "worst_level": tdiag.WARN, "error_fraction": 0.0}


def test_stage_timer(tmp_path):
    t = tdiag.StageTimer()
    with t.time("scan_to_scan"):
        pass
    s = t.summary()
    assert "scan_to_scan" in s and s["scan_to_scan"]["count"] == 1
    log = tdiag.DiagnosticsLog()
    log.add(tdiag.from_step_output(0.5, _Out()))
    log.dump_jsonl(str(tmp_path / "d.jsonl"))
    assert (tmp_path / "d.jsonl").read_text().count("\n") == 1
