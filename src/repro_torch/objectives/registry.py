"""Objective registry: name -> factory, with ``name:arg`` parameterization
(twin of ``repro.objectives.registry``).

    get_objective("logistic")          # the paper's symmetric-logit binary
    get_objective("multiclass:5")      # 5-class softmax, K = 5 trees a round
    get_objective("quantile:0.9")      # 0.9-pinball regression
    get_objective(BinaryLogistic())    # instances pass through
"""
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


def registered_objectives() -> dict[str, Callable[..., Objective]]:
    """Canonical name -> factory (aliases excluded)."""
    seen, out = set(), {}
    for name, factory in _REGISTRY.items():
        if id(factory) not in seen:
            seen.add(id(factory))
            out[name] = factory
    return out


def _parse_arg(raw: str):
    try:
        return int(raw)
    except ValueError:
        return float(raw)


def get_objective(spec, **kwargs) -> Objective:
    """Resolve an Objective from an instance, a name, or ``name:arg``."""
    if isinstance(spec, Objective):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"objective spec must be Objective or str, got {type(spec)}")
    name, _, arg = spec.partition(":")
    if name not in _REGISTRY:
        raise ValueError(f"unknown objective {name!r}; registered: {sorted(_REGISTRY)}")
    factory = _REGISTRY[name]
    if arg:
        return factory(_parse_arg(arg), **kwargs)
    return factory(**kwargs)
