"""NDT of the port against `locus_tpu.registration.ndt` and the float64
oracle (tests/oracle_ndt.py), on the fixtures of tests/test_ndt.py.

Tolerances:
- `build_ndt_targets`: the hash tables (slot keys, slot segments) and
  `valid` exactly, on clouds with hash collisions; means within 1e-5
  relative, inverse covariances within 1e-5 of their largest entry (the
  adjugate's products cancel in f32, so a small entry's relative error is
  not meaningful).
- The Moré–Thuente machine on JAX's scalar objectives: alpha within 1e-6.
- `ndt_register`: transform within 1e-4 m / 1e-4 rad of JAX, equal
  iteration counts and convergence, for every neighbourhood, optimizer
  and line search. The JAX side runs its XLA path and, for the final
  correspondence pass, its Pallas path in interpret mode (the port always
  takes kernel B2 there).
- Against the oracle: the oracle's polish of the port's solution moves it
  by less than 0.02 m / 0.01 rad, the gate tests/test_oracle.py holds the
  JAX package to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu.config import RegistrationConfig as JRC
from locus_tpu.core.cloud import PointCloud as JPC
from locus_tpu.geometry import se3 as jse3
from locus_tpu.io import synthetic
from locus_tpu.ops.dispatch import force_pallas
from locus_tpu.registration import ndt as jndt
from locus_tpu_torch.config import RegistrationConfig as TRC
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.registration import ndt as tndt
from locus_tpu_torch.registration.registry import make_registrar
from tests.oracle_gicp import _matrix_to_rotvec
from tests.oracle_ndt import oracle_ndt
from tests.torch_helpers import np_, pose_diff, torch_cloud

TOL = 1e-4


def room_cloud(capacity=2048, jitter=0.01, seed=0, side=4.0, step=0.15):
    xyz, nrm = synthetic.hollow_cube(step=step, side=side, jitter=jitter, seed=seed)
    return JPC.from_points(xyz, capacity=capacity, normals=nrm)


def tunnel_scan(capacity=4096, seed=2):
    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=512, step=0.3, seed=seed)
    xyz = seq.scans[0][seq.scan_valid[0]][:capacity].astype(np.float32)
    return JPC.from_points(jnp.asarray(xyz), capacity=capacity)


@pytest.mark.parametrize("cloud,res", [("room", 1.0), ("room", 0.5), ("tunnel", 1.0), ("tunnel", 0.3)])
def test_build_targets_match(cloud, res):
    j_pc = room_cloud() if cloud == "room" else tunnel_scan()
    j = jndt.build_ndt_targets(j_pc, res)
    t = tndt.build_ndt_targets(torch_cloud(j_pc), res)
    for f in ("valid", "slot_keys", "slot_seg"):
        np.testing.assert_array_equal(np_(getattr(t, f)), np_(getattr(j, f)), err_msg=f)
    v = np_(j.valid)
    assert v.sum() > 10
    np.testing.assert_allclose(np_(t.means), np_(j.means), rtol=1e-5, atol=0)
    ti, ji = np_(t.icov6)[v], np_(j.icov6)[v]
    scale = np.abs(ji).max(axis=1, keepdims=True)
    np.testing.assert_allclose(ti / scale, ji / scale, rtol=0, atol=1e-5)


def test_hash_table_collisions_keep_the_last_voxel():
    """With 0.3 m voxels the tunnel scan's voxels collide in the 4n-slot
    table; the later voxel in key order owns the slot, as in JAX."""
    j_pc = tunnel_scan()
    t = tndt.build_ndt_targets(torch_cloud(j_pc), 0.3)
    keys = np.unique(np_(tndt._encode_keys(torch.floor(torch_cloud(j_pc).xyz / 0.3).to(torch.int32)))[np_(j_pc.mask)])
    slots = np_(tndt._hash_slot(torch.as_tensor(keys), t.slot_keys.shape[0]))
    assert len(np.unique(slots)) < len(slots), "the fixture must collide"
    for s in np.unique(slots):
        assert np_(t.slot_keys)[s] == keys[slots == s].max()


def test_hash_matches_uint32():
    keys = jnp.asarray(np.array([0, 1, 12345, (1 << 30) - 1, 2147483647, 536870912], np.int32))
    for size in (4096, 131072, 1000):
        np.testing.assert_array_equal(
            np_(tndt._hash_slot(torch.tensor(np.asarray(keys)), size)), np_(jndt._hash_slot(keys, size))
        )


def _phi_quadratic(a):
    return (a - 0.7) ** 2, 2.0 * (a - 0.7)


def _phi_quartic(a):
    # a steep far side: the first trial fails sufficient decrease
    return (a - 0.05) ** 4 - 0.3 * a, 4.0 * (a - 0.05) ** 3 - 0.3


@pytest.mark.parametrize("case", [
    (_phi_quadratic, 0.49, -1.4, 0.2, 0.0005, 1.0),
    (_phi_quadratic, 0.49, -1.4, 0.5, 0.0005, 0.1),
    (_phi_quadratic, 0.49, -1.4, 3.0, 0.0005, 5.0),
    (_phi_quartic, 0.05 ** 4, -4 * 0.05 ** 3 - 0.3, 2.0, 0.0005, 4.0),
])
def test_more_thuente_matches(case):
    phi, phi_0, d_phi_0, step_init, step_min, step_max = case
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    ja = jax.jit(lambda: jndt._more_thuente_alpha(phi, f32(phi_0), f32(d_phi_0), f32(step_init), f32(step_min), f32(step_max)))()
    t32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    ta = tndt._more_thuente_alpha(phi, t32(phi_0), t32(d_phi_0), t32(step_init), t32(step_min), t32(step_max))
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)
    assert step_min <= float(ta) <= step_max + 1e-6


def _shifted(target, shift):
    """The target moved by -shift (the fixtures of test_ndt.py)."""
    src = target.xyz - jnp.asarray(shift, jnp.float32)[None, :]
    return JPC(jnp.where(target.mask[:, None], src, target.xyz), target.normals, target.intensity, target.mask)


def _rotated(target, w, t):
    T = jse3.make_transform(jse3.so3_exp(jnp.asarray(w, jnp.float32)), jnp.asarray(t, jnp.float32))
    src = jse3.transform_points(jse3.inverse(T), target.xyz)
    return JPC(jnp.where(target.mask[:, None], src, target.xyz), target.normals, target.intensity, target.mask)


CASES = {
    "irls_direct1": dict(neighborhood="direct1"),
    "irls_direct7": dict(neighborhood="direct7"),
    "irls_direct26": dict(neighborhood="direct26"),
    "irls_kdtree": dict(neighborhood="kdtree"),
    "irls_rotation": dict(neighborhood="direct7", rotation=True),
    "newton_more_thuente": dict(ndt_optimizer="newton", ndt_line_search="more_thuente"),
    "newton_armijo": dict(ndt_optimizer="newton", ndt_line_search="armijo"),
    "newton_cold": dict(ndt_optimizer="newton", ndt_newton_warmstart=0, rotation=True),
    "irls_iteration_cap": dict(neighborhood="direct7", iterations=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ndt_register_matches_jax(case):
    c = dict(CASES[case])
    rotation = c.pop("rotation", False)
    nb = c.pop("neighborhood", "direct7")
    kw = dict(registration_method="ndt", ndt_resolution=1.0, iterations=30, corr_dist=1.0, ndt_neighborhood=nb) | c
    target = room_cloud(seed=3)
    source = _rotated(target, [0.0, 0.0, 0.06], [0.1, 0.05, -0.02]) if rotation else _shifted(target, [0.12, -0.06, 0.04])
    with force_pallas():
        j = jndt.ndt_register(source, target, cfg=JRC(**kw))
    t = tndt.ndt_register(torch_cloud(source), torch_cloud(target), cfg=TRC(**kw))
    dt, dr = pose_diff(np_(t.transform), np_(j.transform))
    assert dt < TOL and dr < TOL, (dt, dr)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_correspondences) == int(j.num_correspondences)
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(np_(t.corr_mask), np_(j.corr_mask))


def test_ndt_guess_and_small_source_match_jax():
    """A guess pre-warps the source; below 128 source points the final
    pass is the dense 1-NN in both."""
    target = room_cloud(seed=1)
    source = _shifted(target, [0.1, 0.0, 0.05])
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = [0.08, 0.01, 0.03]
    kw = dict(registration_method="ndt", ndt_resolution=1.0, iterations=30)
    j = jndt.ndt_register(source, target, jnp.asarray(guess), JRC(**kw))
    t = tndt.ndt_register(torch_cloud(source), torch_cloud(target), torch.as_tensor(guess), TRC(**kw))
    dt, dr = pose_diff(np_(t.transform), np_(j.transform))
    assert dt < TOL and dr < TOL, (dt, dr)
    small = JPC.from_points(np_(source.xyz)[:100], capacity=100)
    j = jndt.ndt_register(small, target, cfg=JRC(**kw))
    t = tndt.ndt_register(torch_cloud(small), torch_cloud(target), cfg=TRC(**kw))
    dt, dr = pose_diff(np_(t.transform), np_(j.transform))
    assert dt < TOL and dr < TOL, (dt, dr)
    np.testing.assert_array_equal(np_(t.correspondences)[np_(t.corr_mask)], np_(j.correspondences)[np_(j.corr_mask)])


def test_ndt_matches_oracle():
    """The float64 oracle's polish of the port's solution barely moves it
    (tests/test_oracle.py::test_ndt_oracle_confirms_repo_solution_synthetic)."""
    xyz, nrm = synthetic.hollow_cube(step=0.15, side=4.0, jitter=0.01, seed=2)
    tgt = JPC.from_points(xyz, capacity=2048, normals=nrm)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.12, -0.06, 0.04]
    src = tgt.transform(jnp.asarray(np.linalg.inv(T_true)))
    r = tndt.ndt_register(torch_cloud(src), torch_cloud(tgt), cfg=TRC(registration_method="ndt", ndt_resolution=1.0, iterations=40))
    Tr = np_(r.transform).astype(np.float64)
    x0 = np.concatenate([Tr[:3, 3], _matrix_to_rotvec(Tr[:3, :3])])
    To, conv, score = oracle_ndt(np_(src.xyz)[np_(src.mask)].astype(np.float64),
                                 np_(tgt.xyz)[np_(tgt.mask)].astype(np.float64),
                                 resolution=1.0, x0=x0, return_score=True)
    assert conv
    dt, dr = pose_diff(To, Tr)
    assert dt < 0.02 and dr < 0.01, (dt, dr)
    assert score(x0) < score(np.zeros(6)) - 100.0


def test_registry_resolves_ndt_and_rejects_unknown():
    src = torch_cloud(room_cloud())
    res = make_registrar(TRC(registration_method="ndt", ndt_resolution=0.5))(src, src)
    np.testing.assert_allclose(np_(res.transform), np.eye(4), atol=0.02)
    with pytest.raises(ValueError):
        tndt.ndt_register(src, src, cfg=TRC(registration_method="ndt", ndt_neighborhood="direct99"))
    with pytest.raises(ValueError):
        make_registrar(dataclasses.replace(TRC(), registration_method="icp"))
