"""Training objectives (twin of ``repro.objectives``; logistic only so far).

Importing this package registers the built-ins.
"""
from repro_torch.objectives.base import Objective
from repro_torch.objectives.classification import BinaryLogistic
from repro_torch.objectives.registry import get_objective, register

__all__ = ["Objective", "BinaryLogistic", "get_objective", "register"]
