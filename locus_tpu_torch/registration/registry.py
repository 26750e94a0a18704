"""Registration method registry (counterpart of
`locus_tpu/registration/registry.py`). This slice registers GICP; NDT
comes with ROADMAP item A10."""
from __future__ import annotations

from typing import Callable

from locus_tpu_torch.config import RegistrationConfig


def make_registrar(cfg: RegistrationConfig) -> Callable:
    """Returns align(source, target, guess) -> GICPResult for the
    configured method."""
    if cfg.registration_method == "ndt":
        raise NotImplementedError("NDT registration: ROADMAP A10")
    if cfg.registration_method != "gicp":
        raise ValueError(
            f"Unknown registration method {cfg.registration_method!r}; available: ['gicp']"
        )
    from locus_tpu_torch.registration.gicp import gicp_register

    def align(source, target, guess=None, **kw):
        return gicp_register(source, target, guess=guess, cfg=cfg, **kw)

    return align
