"""Model zoo of the PyTorch/CUDA port (twin of ``repro.models``): the dense
family, the MoE one on one device (phi3.5-moe, dbrx), the hybrid one
(zamba2: Mamba2 layers and a shared attention block), the VLM and audio
ones (llama-3.2-vision, whisper) and the xLSTM one (mLSTM and sLSTM
layers), each with training, prefill and decode."""
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
