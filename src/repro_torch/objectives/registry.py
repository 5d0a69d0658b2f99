"""Objective registry: name -> factory (twin of ``repro.objectives.registry``)."""
from __future__ import annotations

from typing import Callable

from repro_torch.objectives.base import Objective

_REGISTRY: dict[str, Callable[..., Objective]] = {}


def register(name: str, *aliases: str):
    """Class/factory decorator adding an objective under ``name`` (+aliases)."""

    def deco(factory):
        for key in (name, *aliases):
            if key in _REGISTRY:
                raise ValueError(f"objective {key!r} registered twice")
            _REGISTRY[key] = factory
        return factory

    return deco


def get_objective(spec) -> Objective:
    """Resolve an Objective from an instance or a registered name."""
    if isinstance(spec, Objective):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"objective spec must be Objective or str, got {type(spec)}")
    if spec not in _REGISTRY:
        raise ValueError(f"unknown objective {spec!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[spec]()
