"""whisper-small [audio] — encoder-decoder backbone; conv frontend stubbed.

12L (enc) + 12L (dec) d_model=768 12H (kv=12, MHA) d_ff=3072 vocab=51865.
input_specs() provides precomputed mel/conv frame embeddings (B, 1500, 768).
[arXiv:2212.04356]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    n_media_tokens=1500,
    rope_theta=10_000.0,
    # long_500k: SKIPPED (see DESIGN.md — 30 s / 448-token decoding horizon,
    # full-attention enc-dec family has no sub-quadratic variant).
)
