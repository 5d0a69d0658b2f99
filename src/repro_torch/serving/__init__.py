"""serving of the PyTorch/CUDA port (twin of ``repro.serving``)."""
from repro_torch.serving.engine import Completion, Request, ServingEngine
from repro_torch.serving.forest_server import ForestServer, PredictRequest, PredictResult

__all__ = [
    "Completion",
    "Request",
    "ServingEngine",
    "ForestServer",
    "PredictRequest",
    "PredictResult",
]
