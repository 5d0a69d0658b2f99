"""Training objectives (twin of ``repro.objectives``): K-output losses
through every layer. See ``base.Objective`` for the protocol and
``registry.get_objective`` for name resolution. Importing this package
registers the built-ins.
"""
from repro_torch.objectives.base import Objective
from repro_torch.objectives.classification import BinaryLogistic, MulticlassSoftmax
from repro_torch.objectives.ranking import LambdaRank
from repro_torch.objectives.registry import get_objective, register, registered_objectives
from repro_torch.objectives.regression import Huber, Quantile, SquaredError

__all__ = [
    "Objective",
    "BinaryLogistic",
    "MulticlassSoftmax",
    "SquaredError",
    "Quantile",
    "Huber",
    "LambdaRank",
    "get_objective",
    "register",
    "registered_objectives",
]
