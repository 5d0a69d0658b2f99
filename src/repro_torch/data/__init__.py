"""data of the PyTorch/CUDA port (twin of ``repro.data``): the synthetic
datasets, Bernoulli sampling, and the packed token pipeline."""
from repro_torch.data.pipeline import TokenPipeline, pack_documents

__all__ = ["TokenPipeline", "pack_documents"]
