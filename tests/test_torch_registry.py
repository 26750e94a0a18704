"""The open registration registry (`registration/registry.py`) against the
JAX package's: a method registered under a new name in both packages runs
in both registration stages of a 12-scan replay.

The method is the built-in GICP with every other source point masked out.
Tolerance: each pose within 1e-2 m and 1e-2 rad of JAX's, the tolerance of
tests/test_torch_pipeline.py's replays on this tunnel (f32 rounding of the
scan-to-submap GICP that ends on its iteration cap). The port's replay must
also part from its plain GICP replay, which shows that the registered
method ran. Unknown names raise ValueError in both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locus_tpu import runner as jrunner
from locus_tpu.config import FusionConfig
from locus_tpu.io.dataset import make_tunnel_sequence
from locus_tpu.registration import gicp as jgicp
from locus_tpu.registration import registry as jregistry
from locus_tpu_torch import runner as trunner
from locus_tpu_torch.config import RegistrationConfig as TRC
from locus_tpu_torch.convert import config_from_dict
from locus_tpu_torch.io.dataset import Sequence as TSequence
from locus_tpu_torch.registration import gicp as tgicp
from locus_tpu_torch.registration import registry as tregistry
from tests.test_pipeline import small_cfg
from tests.torch_helpers import pose_diff

NAME = "gicp_every_other_point"
POSE_TOL_M = 1e-2
POSE_TOL_RAD = 1e-2


def _jax_every_other(source, target, guess=None, cfg=None, **kw):
    keep = source.mask & (jnp.arange(source.mask.shape[-1]) % 2 == 0)
    return jgicp.gicp_register(source.with_mask(keep), target, guess=guess, cfg=cfg, **kw)


def _port_every_other(source, target, guess=None, cfg=None, **kw):
    keep = source.mask & (torch.arange(source.mask.shape[-1], device=source.mask.device) % 2 == 0)
    return tgicp.gicp_register(source.with_mask(keep), target, guess=guess, cfg=cfg, **kw)


@pytest.fixture
def registered():
    """The method in both registries for the test, taken out again after
    it (no file of either package changes)."""
    jregistry.register_method(NAME)(_jax_every_other)
    tregistry.register_method(NAME)(_port_every_other)
    try:
        yield
    finally:
        jregistry._METHODS.pop(NAME, None)
        tregistry._METHODS.pop(NAME, None)


def _both_stages(cfg, **kw):
    R = dataclasses.replace
    return cfg.replace(odometry=R(cfg.odometry, **kw),
                       localization=R(cfg.localization, registration=R(cfg.localization.registration, **kw)))


def test_register_method_is_a_decorator_with_the_jax_contract():
    def fn(source, target, guess=None, cfg=None):
        return "ran", cfg.registration_method

    try:
        assert tregistry.register_method("probe")(fn) is fn
        assert tregistry.make_registrar(TRC(registration_method="probe"))(None, None) == ("ran", "probe")
    finally:
        tregistry._METHODS.pop("probe", None)
    assert "probe" not in tregistry._METHODS


def test_unknown_method_raises_in_both_packages():
    from locus_tpu.config import RegistrationConfig as JRC

    with pytest.raises(ValueError, match="available"):
        jregistry.make_registrar(JRC(registration_method="no_such_method"))
    with pytest.raises(ValueError, match=r"available: \['gicp', 'ndt'\]"):
        tregistry.make_registrar(TRC(registration_method="no_such_method"))


def test_registered_method_replays_in_both_packages(registered):
    seq = make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3, seed=1)
    tseq = TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})
    base = small_cfg(fusion=FusionConfig(data_integration_mode=3))
    jcfg = _both_stages(base, registration_method=NAME)
    jp, _, _ = jrunner.run_sequence(seq, jcfg)
    tp, _, _ = trunner.run_sequence(tseq, config_from_dict(dataclasses.asdict(jcfg)), device="cpu")
    for i, (a, b) in enumerate(zip(tp, jp)):
        dt, dr = pose_diff(a, b)
        assert dt < POSE_TOL_M and dr < POSE_TOL_RAD, (i, dt, dr)
    plain, _, _ = trunner.run_sequence(tseq, config_from_dict(dataclasses.asdict(base)), device="cpu")
    assert np.abs(tp[:, :3, 3] - plain[:, :3, 3]).max() > 0.0
