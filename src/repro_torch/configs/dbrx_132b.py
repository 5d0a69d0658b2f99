"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352.
[hf:databricks/dbrx-base]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    long_context_window=8192,  # opt-in SWA variant for long_500k only
)
