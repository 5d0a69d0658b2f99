"""codeqwen1.5-7b [dense] — qwen1.5 arch, full MHA (kv=32).

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416. [hf:Qwen/CodeQwen1.5-7B]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1_000_000.0,
    long_context_window=8192,
)
