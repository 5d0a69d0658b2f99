"""Flash-attention forward: CUDA kernel wrapper and its plain version.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``. The
kernel (``csrc/flash_attention.cu``) says what bounds it and how its design
answers that. Both functions here take head-major views: q (B, H, Sq, d)
and k, v (B, KV, Sk, d), where q head h reads kv head h // (H // KV). The
reference kernel's flattened layout, q (B*H, Sq, d) and k (B*KV, Sk, d)
with ``group`` q heads a kv head, is the view ``q.view(B*KV, group, Sq, d)``,
``k.view(B*KV, 1, Sk, d)``. The model's (B, S, H, d) tensors are the view
``x.transpose(1, 2)``, which the kernel reads in place through its strides.

A CPU tensor runs ``flash_attention_plain``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches, counted where the kernel is launched

HEAD_DIMS = (32, 64, 80, 128)  # the kernel's compile-time head dims


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    seq_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the f32 softmax of ``ref.flash_attention_ref``
    (p is not rounded to v's dtype before p . v, as the kernel rounds it).
    Returns out (B, H, Sq, d) in q's dtype and lse (B, H, Sq) f32."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out, lse = ref.flash_attention_ref(
        q.reshape(b * h, sq, d), k.reshape(b * kv, sk, d), v.reshape(b * kv, sk, d),
        causal=causal, group=h // kv, seq_k=seq_k,
    )
    return out.view(b, h, sq, d), lse.view(b, h, sq)


def _check_view(t: torch.Tensor, name: str, shape: tuple, dtype, device) -> None:
    """A kernel operand: device, dtype, shape, a contiguous last dimension,
    and 16-byte aligned rows (the kernel loads 16 bytes a thread)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous last dimension, strides that are "
                         "multiples of 8 and a 16-byte aligned start")


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, d)
    k: torch.Tensor,  # (B, KV, Sk, d)
    v: torch.Tensor,  # (B, KV, Sk, d)
    causal: bool = True,
    seq_k: int | None = None,  # keys at or past seq_k are masked (default Sk)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention with an online softmax -> (out, lse).

    out is (B, H, Sq, d) in q's dtype, laid out in memory as (B, Sq, H, d),
    so ``out.transpose(1, 2)`` is the model layout without a copy; lse is
    (B, H, Sq) f32, the natural-log normalizer of each row. bf16 and f32
    inputs are taken, at head dims 32, 64, 80 and 128.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, seq_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    global launches
    dev = q.device
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: dtype {q.dtype}; the kernel takes bf16 or f32")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d}; the kernel is built for {HEAD_DIMS}")
    if kv < 1 or h % kv:
        raise ValueError(f"flash_attention: {h} q heads do not group over {kv} kv heads")
    seq_k = sk if seq_k is None else seq_k
    if not 1 <= seq_k <= sk:
        raise ValueError(f"flash_attention: seq_k {seq_k} outside [1, {sk}]")
    if b * h > 65535:
        raise ValueError(f"flash_attention: {b * h} (batch, head) pairs exceed the grid")
    _check_view(q, "q", (b, h, sq, d), q.dtype, dev)
    _check_view(k, "k", (b, kv, sk, d), q.dtype, dev)
    _check_view(v, "v", (b, kv, sk, d), q.dtype, dev)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if sq == 0:
        return out, lse
    fn = _build.function(
        "flash_attention", "flash_attention_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 12
        + [ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), d, b, h, kv, sq, sk, seq_k, int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        _build.stream_of(dev),
    )
    _build.check(err, "flash_attention kernel")
    launches += 1
    return out, lse
