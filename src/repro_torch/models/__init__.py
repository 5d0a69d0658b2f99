"""Model zoo of the PyTorch/CUDA port (twin of ``repro.models``): the dense
family, the MoE one on one device (phi3.5-moe, dbrx) and the hybrid one
(zamba2: Mamba2 layers and a shared attention block), each with training,
prefill and decode; the VLM, audio and xLSTM families raise
``NotImplementedError``."""
from repro_torch.models.cache import init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    LanguageModel,
    decode_step,
    forward_train,
    init_params,
    param_schema,
    prefill,
)

__all__ = [
    "ModelConfig",
    "LanguageModel",
    "init_params",
    "param_schema",
    "prefill",
    "decode_step",
    "forward_train",
    "init_cache",
]
