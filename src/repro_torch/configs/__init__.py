"""Assigned-architecture registry: ``get(arch_id)`` -> ModelConfig.

Each module pins the exact dims from the assignment (source in brackets in
its docstring). GBDT configs for the paper's own experiments live in
``repro_torch.configs.gbdt``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "h2o_danube_1_8b",
    "dbrx_132b",
    "minitron_4b",
    "llama_3_2_vision_90b",
    "whisper_small",
    "granite_3_2b",
    "codeqwen1_5_7b",
    "zamba2_1_2b",
    "phi3_5_moe_42b",
    "xlstm_1_3b",
]

# CLI ids (assignment spelling) -> module names
ALIASES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "dbrx-132b": "dbrx_132b",
    "minitron-4b": "minitron_4b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "whisper-small": "whisper_small",
    "granite-3-2b": "granite_3_2b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def get(arch: str) -> ModelConfig:
    mod = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get(a) for a in ALIASES}
