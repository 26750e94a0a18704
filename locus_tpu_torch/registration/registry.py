"""Registration method registry (counterpart of
`locus_tpu/registration/registry.py`): "gicp" and "ndt"."""
from __future__ import annotations

from typing import Callable

from locus_tpu_torch.config import RegistrationConfig

METHODS = ("gicp", "ndt")


def make_registrar(cfg: RegistrationConfig) -> Callable:
    """Returns align(source, target, guess) -> GICPResult for the
    configured method."""
    if cfg.registration_method == "gicp":
        from locus_tpu_torch.registration.gicp import gicp_register as register
    elif cfg.registration_method == "ndt":
        from locus_tpu_torch.registration.ndt import ndt_register as register
    else:
        raise ValueError(
            f"Unknown registration method {cfg.registration_method!r}; available: {list(METHODS)}"
        )

    def align(source, target, guess=None, **kw):
        return register(source, target, guess=guess, cfg=cfg, **kw)

    return align
