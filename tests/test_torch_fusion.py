"""The port's sensor fusion (`locus_tpu_torch/fusion.py`) against the JAX
package's: the cases of tests/test_fusion.py, each run through both
packages on the same numpy inputs. Every prior source, pure-LO flag and
buffer content must be equal, and every prior within 1e-6 (f32 rounding
of the same quaternion and pose algebra); the JAX test's own assertions
are then checked on the port's results.

test_fusion.py's `test_load_imu_calibration_quat` reads a sensors file
through `io/sensors.py`, which the port does not have yet (ROADMAP 13);
in its place the single-sample pushes are held against the batched ones.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import fusion as jf
from locus_tpu.config import FusionConfig
from locus_tpu.geometry import se3 as jse3
from locus_tpu_torch import config as tconfig
from locus_tpu_torch import fusion as tf
from locus_tpu_torch.geometry import se3 as tse3
from tests.torch_helpers import np_

TOL = 1e-6
CFG = FusionConfig(imu_buffer_size=16, odometry_buffer_size=16)


def quat_yaw(yaw):
    return np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], np.float32)


def pose_x(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = x
    return T


def _tcfg(cfg):
    return tconfig.FusionConfig(**dataclasses.asdict(cfg))


def both(scenario, cfg=CFG):
    """Run `scenario(fusion module, cfg, initial state)` in both packages;
    every value it returns must agree. Returns the port's values."""
    jout = scenario(jf, cfg, jf.init_state(cfg))
    tcfg = _tcfg(cfg)
    tout = scenario(tf, tcfg, tf.init_state(tcfg, device="cpu"))
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        a, b = np_(a), np_(b)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (a, b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
        else:
            np.testing.assert_array_equal(b, a)
    return tout


def selection(sel):
    return [sel.source, sel.prior, sel.pure_lo]


def test_push_and_lookup_imu():
    def scenario(fm, cfg, st):
        for t in [0.0, 0.1, 0.2]:
            st = fm.push_imu(st, t, quat_yaw(t))
        stamp = 0.11 if fm is jf else torch.tensor(0.11)
        i, found = fm._nearest_in_buffer(st.imu.stamps, st.imu.valid, stamp, 0.1)
        return [st.imu.data, st.imu.ptr, st.imu.last_reception, i, found, st.imu.stamps[i]]

    *_, found, stamp = both(scenario)
    assert bool(found)
    assert float(stamp) == pytest.approx(0.1, abs=1e-6)


def test_staleness_rejection():
    def scenario(fm, cfg, st):
        st = fm.push_imu(st, 0.0, quat_yaw(0.0))
        stamp = 5.0 if fm is jf else torch.tensor(5.0)
        return [fm._nearest_in_buffer(st.imu.stamps, st.imu.valid, stamp, 0.1)[1]]

    assert not bool(both(scenario)[0])


@pytest.mark.parametrize("which", ["imu", "odom"])
def test_nan_dropped(which):
    def scenario(fm, cfg, st):
        if which == "imu":
            st = fm.push_imu(st, 0.0, np.array([np.nan, 0, 0, 0], np.float32))
        else:
            bad = pose_x(1.0)
            bad[1, 2] = np.nan
            st = fm.push_odom(st, 0.0, bad)
        buf = getattr(st, which)
        return [buf.data, buf.ptr, buf.last_reception, buf.valid.sum()]

    assert int(both(scenario)[-1]) == 0


def test_cascade_prefers_odom():
    cfg = FusionConfig(data_integration_mode=3)

    def scenario(fm, cfg, st):
        st = fm.push_imu(st, 0.95, quat_yaw(0.1), wall_time=0.95)
        st = fm.push_odom(st, 0.9, pose_x(1.0), wall_time=0.9)
        st = fm.push_odom(st, 1.0, pose_x(1.5), wall_time=1.0)
        a = fm.integrate_sensors(st, 0.9, 1.0, cfg)
        b = fm.integrate_sensors(a.state, 1.0, 1.05, cfg)
        return selection(a) + selection(b)

    s0, p0, _, s1, p1, _ = both(scenario, cfg)
    assert int(s0) == tf.PRIOR_NONE
    np.testing.assert_allclose(np_(p0), np.eye(4), atol=1e-6)
    assert int(s1) == tf.PRIOR_ODOM
    np.testing.assert_allclose(np_(p1)[:3, 3], [0.5, 0, 0], atol=1e-5)


def test_cascade_falls_back_to_imu_then_pure_lo():
    cfg = FusionConfig(data_integration_mode=3, sensor_health_timeout=0.4)

    def scenario(fm, cfg, st):
        st = fm.push_imu(st, 0.0, quat_yaw(0.0), wall_time=0.0)
        st = fm.push_imu(st, 0.1, quat_yaw(0.2), wall_time=0.1)
        a = fm.integrate_sensors(st, 0.0, 0.1, cfg)
        b = fm.integrate_sensors(a.state, 0.1, 0.15, cfg)
        c = fm.integrate_sensors(b.state, 1.0, 1.0, cfg)
        return selection(a) + selection(b) + selection(c)

    s0, _, _, s1, p1, _, _, p2, lo2 = both(scenario, cfg)
    assert int(s0) == tf.PRIOR_NONE and int(s1) == tf.PRIOR_IMU
    R = np_(p1)[:3, :3]
    np.testing.assert_allclose(np.arctan2(R[1, 0], R[0, 0]), 0.2, atol=1e-4)
    assert bool(lo2)
    np.testing.assert_allclose(np_(p2), np.eye(4), atol=1e-6)


def test_mode_gates_integration():
    cfg = FusionConfig(data_integration_mode=0)

    def scenario(fm, cfg, st):
        st = fm.push_odom(st, 1.0, pose_x(1.0), wall_time=1.0)
        return selection(fm.integrate_sensors(st, 1.0, 1.0, cfg))

    assert bool(both(scenario, cfg)[2])


def test_yaw_only_mode():
    cfg = FusionConfig(data_integration_mode=2)
    q0 = np.array(jse3.matrix_to_quat(jse3.so3_exp(jnp.asarray([0.1, 0.05, 0.0]))))
    q1 = np.array(jse3.matrix_to_quat(jse3.compose(
        jse3.make_transform(jse3.so3_exp(jnp.asarray([0.1, 0.05, 0.0])), jnp.zeros(3)),
        jse3.make_transform(jse3.so3_exp(jnp.asarray([0.0, 0.0, 0.3])), jnp.zeros(3)),
    )[:3, :3]))

    def scenario(fm, cfg, st):
        st = fm.push_imu(st, 0.0, q0, wall_time=0.0)
        st = fm.push_imu(st, 0.1, q1, wall_time=0.1)
        a = fm.integrate_sensors(st, 0.0, 0.05, cfg)
        return selection(fm.integrate_sensors(a.state, 0.1, 0.1, cfg))

    source, prior, _ = both(scenario, cfg)
    assert int(source) == tf.PRIOR_IMU_YAW
    r, p, y = (float(v) for v in tse3.matrix_to_euler_zyx(prior[:3, :3]))
    assert abs(r) < 1e-5 and abs(p) < 1e-5
    assert abs(y - 0.3) < 0.02


def test_odom_outage_reanchor_semantics():
    """An outage resets the anchor: the first scan after resurrection is
    prior-free and the next delta spans only the post-resume interval."""
    cfg = FusionConfig(data_integration_mode=3, sensor_health_timeout=0.4)

    def scenario(fm, cfg, st):
        out = []
        st = fm.push_odom(st, 0.0, pose_x(0.0), wall_time=0.0)
        sel = fm.integrate_sensors(st, 0.0, 0.0, cfg)
        out += selection(sel)
        st = fm.push_odom(sel.state, 0.1, pose_x(0.5), wall_time=0.1)
        sel = fm.integrate_sensors(st, 0.1, 0.1, cfg)
        out += selection(sel)
        sel = fm.integrate_sensors(sel.state, 1.0, 1.0, cfg)
        out += selection(sel)
        st = fm.push_odom(sel.state, 1.5, pose_x(3.0), wall_time=1.5)
        sel = fm.integrate_sensors(st, 1.5, 1.5, cfg)
        out += selection(sel)
        st = fm.push_odom(sel.state, 1.6, pose_x(3.2), wall_time=1.6)
        return out + selection(fm.integrate_sensors(st, 1.6, 1.6, cfg))

    out = both(scenario, cfg)
    sources = [int(out[k]) for k in range(0, 15, 3)]
    assert sources == [tf.PRIOR_NONE, tf.PRIOR_ODOM, tf.PRIOR_NONE, tf.PRIOR_NONE, tf.PRIOR_ODOM]
    assert bool(out[8]) and bool(out[11])
    np.testing.assert_allclose(np_(out[4])[:3, 3], [0.5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np_(out[10]), np.eye(4), atol=1e-6)
    np.testing.assert_allclose(np_(out[13])[:3, 3], [0.2, 0, 0], atol=1e-5)


def test_odom_lookup_miss_spans_gap():
    """A lookup miss while the sensor stays healthy keeps the anchor, so
    the next delta spans the missed interval."""
    cfg = FusionConfig(data_integration_mode=3, sensor_health_timeout=0.4, max_buffer_staleness=0.1)

    def scenario(fm, cfg, st):
        out = []
        st = fm.push_odom(st, 0.0, pose_x(0.0), wall_time=0.0)
        sel = fm.integrate_sensors(st, 0.0, 0.0, cfg)
        st = fm.push_odom(sel.state, 0.1, pose_x(0.5), wall_time=0.1)
        sel = fm.integrate_sensors(st, 0.1, 0.1, cfg)
        out += selection(sel)
        st = fm.push_odom(sel.state, 0.1, pose_x(0.5), wall_time=0.25)
        sel = fm.integrate_sensors(st, 0.3, 0.3, cfg)
        out += selection(sel)
        st = fm.push_odom(sel.state, 0.4, pose_x(1.7), wall_time=0.4)
        return out + selection(fm.integrate_sensors(st, 0.4, 0.4, cfg))

    s1, _, _, s2, _, lo2, s3, p3, _ = both(scenario, cfg)
    assert (int(s1), int(s2), int(s3)) == (tf.PRIOR_ODOM, tf.PRIOR_NONE, tf.PRIOR_ODOM)
    assert bool(lo2)
    np.testing.assert_allclose(np_(p3)[:3, 3], [1.2, 0, 0], atol=1e-5)


def test_batch_push_ignores_padding():
    def scenario(fm, cfg, st):
        stamps = np.array([-np.inf, -np.inf, 0.1, 0.2], np.float32)
        st = fm.push_imu_batch(st, stamps, np.tile(quat_yaw(0.0), (4, 1)))
        return [st.imu.data, st.imu.ptr, st.imu.valid.sum()]

    assert int(both(scenario)[-1]) == 2


def _quat_axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis]).astype(np.float32)


@pytest.mark.parametrize("convert", [True, False])
def test_imu_to_base_frame_conversion(convert):
    """A 90-degree-roll-mounted IMU yields the base-frame yaw prior only
    with b_convert_imu_to_base_link_frame (IntegrateImu,
    Locus.cc:1017-1042)."""
    q_bi = _quat_axis_angle([1, 0, 0], np.pi / 2)
    dq_base = _quat_axis_angle([0, 0, 1], 0.3)

    def imu_sample(q_wb):
        return np.asarray(jse3.quat_multiply(jnp.asarray(q_wb), jnp.asarray(q_bi)))

    q_wb0 = _quat_axis_angle([0, 0, 1], 0.0)
    q_wb1 = np.asarray(jse3.quat_multiply(jnp.asarray(q_wb0), jnp.asarray(dq_base)))
    cfg = FusionConfig(data_integration_mode=1, b_convert_imu_to_base_link_frame=convert,
                       imu_to_base_quat=tuple(float(v) for v in q_bi))

    def scenario(fm, cfg, st):
        st = fm.push_imu(st, 0.0, imu_sample(q_wb0), wall_time=0.0)
        sel = fm.integrate_sensors(st, 0.0, 0.0, cfg)
        st = fm.push_imu(sel.state, 0.1, imu_sample(q_wb1), wall_time=0.1)
        return selection(fm.integrate_sensors(st, 0.1, 0.1, cfg))

    source, prior, _ = both(scenario, cfg)
    assert int(source) == tf.PRIOR_IMU
    err = np.linalg.norm(np_(prior)[:3, :3] - np.asarray(jse3.quat_to_matrix(jnp.asarray(dq_base))))
    assert (err < 1e-5) if convert else (err > 0.1), err


@pytest.mark.parametrize("which", ["imu", "odom"])
def test_single_pushes_equal_a_batched_push(which):
    """push_imu/push_odom one sample at a time fill the ring as one batched
    push of the same window (wall time = stamp), wrapping included."""
    rng = np.random.default_rng(4)
    stamps = np.sort(rng.uniform(0, 2, 20)).astype(np.float32)
    if which == "imu":
        payload = rng.normal(size=(20, 4)).astype(np.float32)
    else:
        payload = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
        payload[:, :3, 3] = rng.normal(size=(20, 3))
    cfg = _tcfg(CFG)
    single = tf.init_state(cfg, device="cpu")
    for s, p in zip(stamps, payload):
        single = (tf.push_imu if which == "imu" else tf.push_odom)(single, float(s), p)
    batched = (tf.push_imu_batch if which == "imu" else tf.push_odom_batch)(
        tf.init_state(cfg, device="cpu"), stamps, payload)
    for a, b in zip(getattr(single, which), getattr(batched, which)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
