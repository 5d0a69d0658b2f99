"""xlstm-1.3b [ssm] — mLSTM blocks with an sLSTM block every 8th layer.

48L d_model=2048 4H (kv=4, head_dim=512 matrix memories) d_ff=0 (the xLSTM
block carries its own 2x up/down projection). [arXiv:2405.04517]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    ssm_chunk=256,
)
