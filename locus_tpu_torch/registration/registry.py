"""Registration method registry (counterpart of
`locus_tpu/registration/registry.py`; the reference's string -> method
dispatch, registration_settings.h, used by both odometry and localization).

The registry is open: `register_method(name)` adds a method under a name
that `make_registrar` then resolves from `registration_method`. GICP is the
built-in; NDT registers itself when `registration/ndt.py` is imported,
which `make_registrar` does late, so that importing the registry does not
import NDT. A registered method is called as
fn(source, target, guess=..., cfg=RegistrationConfig, **kw) and returns a
GICPResult.
"""
from __future__ import annotations

from typing import Callable

from locus_tpu_torch.config import RegistrationConfig

_METHODS = {}


def register_method(name: str):
    """Decorator: register `fn` as registration method `name` (a later
    registration under the same name replaces the earlier one)."""
    def deco(fn: Callable):
        _METHODS[name] = fn
        return fn
    return deco


def make_registrar(cfg: RegistrationConfig) -> Callable:
    """Returns align(source, target, guess) -> GICPResult for the
    configured method; ValueError naming the available methods when no
    method is registered under that name."""
    name = cfg.registration_method
    if name not in _METHODS:
        # late import so that NDT registers itself
        import locus_tpu_torch.registration.ndt  # noqa: F401
    if name not in _METHODS:
        raise ValueError(f"Unknown registration method {name!r}; available: {sorted(_METHODS)}")
    fn = _METHODS[name]

    def align(source, target, guess=None, **kw):
        return fn(source, target, guess=guess, cfg=cfg, **kw)

    return align


def _register_builtins():
    from locus_tpu_torch.registration.gicp import gicp_register

    _METHODS.setdefault("gicp", gicp_register)


_register_builtins()
