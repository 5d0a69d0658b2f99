"""Architecture configuration — one dataclass drives the whole zoo (a copy of
``repro.models.config``; plain data, no framework)."""
from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # Attention
    sliding_window: int = 0  # 0 = full attention (training/prefill mask)
    rope_theta: float = 10_000.0
    attn_chunk: int = 1024  # q-chunk for memory-bounded attention
    # 'chunked' — lax.map q-chunks (XLA-fused, runs everywhere);
    # 'flash'   — the Pallas online-softmax kernel (TPU target; interpret
    #             mode on CPU). Full-causal training/prefill only; SWA and
    #             decode always use the chunked/ring path.
    attn_impl: str = "chunked"

    # VLM / audio frontends (stubs provide embeddings of this shape)
    cross_attn_every: int = 0  # every k-th layer cross-attends (vlm)
    n_media_tokens: int = 0  # image patch / audio frame count
    encoder_layers: int = 0  # whisper encoder depth

    # SSM / hybrid / xlstm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256  # SSD chunk length
    shared_attn_every: int = 0  # zamba2: shared attention block period
    slstm_every: int = 0  # xlstm: every k-th block is sLSTM

    # Serving
    long_context_window: int = 0  # opt-in SWA for the long_500k shape

    dtype: str = "bfloat16"
    remat: bool = True
    # 'full'  — recompute everything in backward (min memory);
    # 'dots'  — save projection-dot outputs (skips replaying the matmuls
    #           AND their tensor-parallel all-reduces in the backward pass;
    #           costs ~n_layers x d_model activations of extra HBM).
    remat_policy: str = "full"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---------------------------------------------------------- derived dims
    @property
    def padded_vocab(self) -> int:
        """Vocab padded for clean sharding (logits masked back in the loss)."""
        return _round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def window_for(self, seq_len: int) -> int:
        """Effective attention window for a given context length."""
        if self.sliding_window:
            return min(self.sliding_window, seq_len)
        if self.long_context_window and seq_len > 262_144:
            return min(self.long_context_window, seq_len)
        return seq_len

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Analytic parameter count (used to cross-check 6ND in the roofline)."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        emb = v * d * 2  # embed + lm head
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = 3 * d * ff
        per_layer = 0
        if self.family in ("dense", "vlm"):
            # vlm: n_layers counts self AND gated-cross layers (the cross
            # layers carry one attention + one MLP, same as a self layer).
            per_layer = attn + mlp
            total = self.n_layers * per_layer
        elif self.family == "moe":
            total = self.n_layers * (attn + self.n_experts * mlp + d * self.n_experts)
        elif self.family == "audio":
            total = (self.encoder_layers + self.n_layers) * (attn + mlp)
            total += self.n_layers * attn  # decoder cross-attention
        elif self.family == "hybrid":
            di, hs, st = self.d_inner, self.ssm_heads, self.ssm_state
            mamba = d * (2 * di + 2 * st + hs) + di * d + 4 * di
            total = self.n_layers * mamba
            if self.shared_attn_every:
                total += attn + mlp  # one shared block
        elif self.family == "ssm":  # xlstm
            # mLSTM: wq wk wv wo_gate wo (5 d^2) + tiny i/f gates;
            # sLSTM: w_gates 4d^2 + wo d^2 + block-diag recurrence 4*d*hd.
            ng = self.n_layers // self.slstm_every if self.slstm_every else 0
            n_mlstm = self.n_layers - ng
            mlstm = 5 * d * d + 2 * self.n_heads * d
            slstm = 5 * d * d + 4 * d * self.head_dim
            total = n_mlstm * mlstm + ng * slstm
        else:
            raise ValueError(self.family)
        return total + emb

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = 3 * d * ff
        per_layer = attn + self.top_k * mlp + d * self.n_experts
        return self.n_layers * per_layer + self.padded_vocab * d * 2

    # --------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers (4 for patterned families),
        d_model <= 512, <= 4 experts — runs a CPU forward/train step."""
        layers = 2
        shared_every = self.shared_attn_every and 2
        slstm_every = self.slstm_every and 2
        cross_every = self.cross_attn_every and 2
        if self.cross_attn_every or self.shared_attn_every or self.slstm_every:
            layers = 4
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=layers,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=64,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            encoder_layers=2 if self.encoder_layers else 0,
            n_media_tokens=16 if self.n_media_tokens else 0,
            cross_attn_every=cross_every,
            shared_attn_every=shared_every,
            slstm_every=slstm_every,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_chunk=64,
            ssm_chunk=16,
            dtype="float32",
        )
