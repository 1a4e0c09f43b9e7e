"""Backend registry: new transports plug in without touching call sites.

A backend is a factory ``(target, topology, *, namespace, resume, **opts) ->
DataPlaneSession``. The three built-ins (tgb, mq, colocated) self-register on
package import; external code can add its own via ``register_backend`` and
callers reach it by name through ``open_dataplane(..., backend="mybackend")``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

__all__ = ["available_backends", "backend_factory", "register_backend"]

_REGISTRY: Dict[str, Callable] = {}


def register_backend(name: str, factory: Callable, *,
                     overwrite: bool = False) -> None:
    """Register a session factory under ``name``."""
    if not name or not isinstance(name, str):
        raise ValueError(f"backend name must be a non-empty string: {name!r}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = factory


def backend_factory(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dataplane backend {name!r}; available: "
            f"{', '.join(available_backends())}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
