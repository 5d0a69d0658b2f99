"""serving of the PyTorch/CUDA port (twin of ``repro.serving``): batched
LM decode, and GBDT forest serving with hot swap and continuous batching."""
from repro_torch.serving.engine import Completion, Request, ServingEngine
from repro_torch.serving.forest_server import (
    ForestServer,
    PredictRequest,
    PredictResult,
    load_forest_checkpoint,
)
from repro_torch.serving.continuous import ForestEngine, percentile_latencies, route_hash

__all__ = [
    "Completion",
    "Request",
    "ServingEngine",
    "ForestServer",
    "ForestEngine",
    "PredictRequest",
    "PredictResult",
    "load_forest_checkpoint",
    "percentile_latencies",
    "route_hash",
]
