"""llama-3.2-vision-90b [vlm] — cross-attention image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
cross-attends to (stubbed) vision-encoder patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    n_media_tokens=1601,  # 1 tile x (40x40 + 1) patches from the ViT stub
    rope_theta=500_000.0,
    long_context_window=8192,
)
