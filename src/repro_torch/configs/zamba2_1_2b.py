"""zamba2-1.2b [hybrid] — Mamba2 backbone + one shared attention block.

38 Mamba2 layers, d_model=2048, ssm_state=64; a single shared
(attention + MLP) block (32H kv=32, d_ff=8192) is invoked every 6 layers,
re-using the same weights each time. [arXiv:2411.15242]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    rope_theta=10_000.0,
)
