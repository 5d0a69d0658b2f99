"""minitron-4b [dense] — width-pruned nemotron.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000. [arXiv:2407.14679]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10_000.0,
    long_context_window=8192,
)
