"""Training objectives (twin of ``repro.objectives``: logistic and
multiclass softmax so far).

Importing this package registers the built-ins.
"""
from repro_torch.objectives.base import Objective
from repro_torch.objectives.classification import BinaryLogistic, MulticlassSoftmax
from repro_torch.objectives.registry import get_objective, register, registered_objectives

__all__ = ["Objective", "BinaryLogistic", "MulticlassSoftmax", "get_objective", "register",
           "registered_objectives"]
