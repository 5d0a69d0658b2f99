"""Flash attention, forward and backward: CUDA kernel wrappers, their plain
versions and the autograd ``FlashAttention`` that joins them.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` (the
forward, ``csrc/flash_attention.cu``, one kernel a route of
``kernels/flash_plan.py``) and ``flash_attention_bwd_pallas`` (dq and
dk/dv, ``csrc/flash_attention_bwd.cu``, two kernels a route of the same
plan module, after a delta pre-pass). Each kernel source says what
bounds it and how its design answers that. The functions here take
head-major views: q (B, H, Sq, d)
and k, v (B, KV, Sk, d), where q head h reads kv head h // (H // KV). The
reference kernel's flattened layout, q (B*H, Sq, d) and k (B*KV, Sk, d)
with ``group`` q heads a kv head, is the view ``q.view(B*KV, group, Sq, d)``,
``k.view(B*KV, 1, Sk, d)``. The model's (B, S, H, d) tensors are the view
``x.transpose(1, 2)``, which the kernel reads in place through its strides.

A CPU tensor runs the plain versions; a CUDA tensor launches the kernels
or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, flash_plan, ref

launches = 0  # forward kernel launches, counted where the kernel is launched
# The same launches by route (flash_plan.ROUTES): which kernel served them.
route_launches = dict.fromkeys(flash_plan.ROUTES, 0)
bwd_launches = 0  # backward launches: one each of the delta, dq and dk/dv kernels
bwd_route_launches = dict.fromkeys(flash_plan.ROUTES, 0)  # the same by route


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


def _check_operands(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_k: int | None) -> int:
    """The kernels' input contract, forward and backward: dtype, head dim,
    grouping, seq_k's range, the grid's limit and q, k, v's views. Returns
    seq_k (Sk where None)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {q.dtype}; the kernels take bf16 or f32")
    if d not in flash_plan.HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}; the kernels are built for "
                         f"{flash_plan.HEAD_DIMS}")
    if kv < 1 or h % kv:
        raise ValueError(f"{name}: {h} q heads do not group over {kv} kv heads")
    seq_k = sk if seq_k is None else seq_k
    if not 1 <= seq_k <= sk:
        raise ValueError(f"{name}: seq_k {seq_k} outside [1, {sk}]")
    if b * h > 65535:
        raise ValueError(f"{name}: {b * h} (batch, head) pairs exceed the grid")
    _check_view(q, "q", (b, h, sq, d), q.dtype, q.device)
    _check_view(k, "k", (b, kv, sk, d), q.dtype, q.device)
    _check_view(v, "v", (b, kv, sk, d), q.dtype, q.device)
    return seq_k


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
    inputs are taken, at head dims 32, 64, 80 and 128; ``flash_plan.plan``
    picks the kernel (bf16 at d 64 and 128: the wgmma kernel).
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, seq_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    dev = q.device
    b, h, sq, d = q.shape
    seq_k = _check_operands("flash_attention", q, k, v, seq_k)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if sq == 0:
        return out, lse
    p = flash_plan.plan(q, k, v, out, seq_k, sms=_multiprocessors(dev))
    _launch_fwd(p, q, k, v, out, lse, causal, seq_k)
    return out, lse


@functools.cache
def _multiprocessors(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_fwd(p: flash_plan.FlashPlan, q, k, v, out, lse, causal: bool, seq_k: int) -> None:
    """Launch the forward kernel of plan ``p`` on checked operands and count
    it (in ``launches`` and ``route_launches``)."""
    global launches
    dev = q.device
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    if p.route == "wgmma":
        fn = _build.function(
            "flash_attention", "flash_attention_wgmma_launch",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p],
        )
        fields = p.fields()
        err = fn(*ptrs, d, b, h, kv, sq, seq_k, int(causal),
                 (ctypes.c_longlong * len(fields))(*fields), _build.stream_of(dev))
    else:
        fn = _build.function(
            "flash_attention", "flash_attention_launch",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 12
            + [ctypes.c_void_p],
        )
        err = fn(
            *ptrs, int(q.dtype == torch.bfloat16), d, b, h, kv, sq, sk, seq_k, int(causal),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            _build.stream_of(dev),
        )
    _build.check(err, f"flash_attention {p.route} kernel")
    with _build.COUNT_LOCK:
        launches += 1
        route_launches[p.route] += 1


def _bwd_terms(q, k, v, out, lse, do, causal: bool, seq_k: int | None):
    """The backward's f32 terms: p (masked) and ds = p (dp - delta), both
    (B, H, Sq, Sk), with q, k (repeated to H heads) and do in f32."""
    sq, sk = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    qf, of, dof = q.float(), out.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)  # (B, H, Sk, d)
    vf = v.float().repeat_interleave(group, dim=1)
    valid = torch.arange(sk, device=q.device)[None, :] < (sk if seq_k is None else seq_k)
    if causal:
        valid = valid & torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / math.sqrt(q.shape[3]))
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * of).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    return p, p * (dp - delta[..., None]), qf, kf, dof


def _bwd_products(p, ds, qf, kf, dof, kv: int):
    """dq, dk and dv from the terms, dk and dv summed over each kv head's
    group of q heads."""
    b, h, sq, d = qf.shape
    sk = kf.shape[2]
    scale = 1.0 / math.sqrt(d)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq, dk.view(b, kv, h // kv, sk, d).sum(2), dv.view(b, kv, h // kv, sk, d).sum(2)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True, seq_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward: the TPU kernels' explicit
    formulas in f32 (no autograd through the forward), P recomputed from
    lse. Shapes as ``flash_attention``; returns (dq, dk, dv) in q's, k's
    and v's dtypes, dk and dv summed over each kv head's group of q heads.
    It rounds nowhere before the end, where the kernels round p and ds to
    the inputs' dtype before their products."""
    terms = _bwd_terms(q, k, v, out, lse, do, causal, seq_k)
    dq, dk, dv = _bwd_products(*terms, k.shape[1])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_magnitudes(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True, seq_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sum of |term| behind each element of dq, dk and dv (f32): the
    scale of the error that rounding p and ds before their products puts
    on that element. ds sums to zero over a row's keys, so an element can
    be far smaller than its terms."""
    p, ds, qf, kf, dof = _bwd_terms(q, k, v, out, lse, do, causal, seq_k)
    return _bwd_products(p, ds.abs(), qf.abs(), kf.abs(), dof.abs(), k.shape[1])


def _bwd_operands(q, k, v, out, lse, do, causal: bool, seq_k: int | None) -> dict:
    """Check the backward's operands (``_check_operands``, then out and do),
    allocate its outputs and plan its launch (``flash_plan.bwd_plan`` on
    q's card): dq (B, H, Sq, d)
    laid out as (B, Sq, H, d), dk and dv (B, KV, Sk, d) laid out as (B, Sk,
    KV, d), delta (B, H, ld) f32 and, on the wgmma route, lse2 = lse log2 e
    (B, H, ld) f32, where ld is the plan's row length. ``do`` is made
    contiguous only where its last dimension is strided."""
    dev = q.device
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    seq_k = _check_operands("flash_attention_bwd", q, k, v, seq_k)
    if do.stride(-1) != 1:
        do = do.contiguous()
    for t, name in ((out, "out"), (do, "do")):
        _check_view(t, name, (b, h, sq, d), q.dtype, dev)
    _build.require(lse, "lse", torch.float32, (b, h, sq), dev)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((b, sk, kv, d), dtype=k.dtype, device=dev).transpose(1, 2)
    dv = torch.empty((b, sk, kv, d), dtype=v.dtype, device=dev).transpose(1, 2)
    plan = flash_plan.bwd_plan(q, k, v, do, dq, dk, dv, seq_k, sms=_multiprocessors(dev))
    rows = (b, h, plan.ld)
    return {
        "q": q, "k": k, "v": v, "out": out, "lse": lse, "do": do, "dq": dq, "dk": dk, "dv": dv,
        "delta": torch.empty(rows, dtype=torch.float32, device=dev),
        "lse2": torch.empty(rows, dtype=torch.float32, device=dev)
        if plan.route == "wgmma" else None,
        "causal": bool(causal), "seq_k": seq_k, "plan": plan,
    }


BWD_KERNELS = ("delta", "dq", "dkv")  # in launch order: dq and dk/dv read delta


def _launch_bwd(kernel: str, o: dict) -> None:
    """Launch one of the backward's kernels on operands from
    ``_bwd_operands``, by the plan's route (no count:
    ``flash_attention_bwd`` counts)."""
    q, k = o["q"], o["k"]
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    plan, stream = o["plan"], _build.stream_of(q.device)
    lse2 = o["lse2"].data_ptr() if o["lse2"] is not None else None
    if kernel != "delta" and plan.route == "wgmma":
        fn = _build.function(
            "flash_attention_bwd", "flash_attention_bwd_wgmma_launch",
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p],
        )
        fields = plan.kernels[kernel].fields()
        err = fn(
            BWD_KERNELS.index(kernel), *(o[n].data_ptr() for n in ("q", "k", "v", "do")), lse2,
            o["delta"].data_ptr(), *(o[n].data_ptr() for n in ("dq", "dk", "dv")), d, b, h, kv,
            sq, sk, o["seq_k"], int(o["causal"]), (ctypes.c_longlong * len(fields))(*fields),
            stream,
        )
        _build.check(err, f"flash_attention_bwd {kernel} wgmma kernel")
        return
    fn = _build.function(
        "flash_attention_bwd", "flash_attention_bwd_launch",
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p],
    )
    names = ("q", "k", "v", "out", "do", "dq", "dk", "dv")
    strides = (ctypes.c_longlong * 24)(*(s for n in names for s in o[n].stride()[:3]))
    err = fn(
        BWD_KERNELS.index(kernel), *(o[n].data_ptr() for n in names[:5]),
        o["lse"].data_ptr(), o["delta"].data_ptr(), lse2, o["dq"].data_ptr(),
        o["dk"].data_ptr(), o["dv"].data_ptr(), int(q.dtype == torch.bfloat16), d, b, h, kv,
        sq, sk, o["seq_k"], int(o["causal"]), plan.ld, strides, stream,
    )
    _build.check(err, f"flash_attention_bwd {kernel} kernel")


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, Sq, d)
    k: torch.Tensor,  # (B, KV, Sk, d)
    v: torch.Tensor,  # (B, KV, Sk, d)
    out: torch.Tensor,  # (B, H, Sq, d), the forward's output
    lse: torch.Tensor,  # (B, H, Sq) f32, the forward's lse
    do: torch.Tensor,  # (B, H, Sq, d), the gradient of out
    causal: bool = True,
    seq_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward -> (dq, dk, dv) in q's, k's and v's dtypes.

    On the card: the delta, dq and dk/dv kernels of the route
    ``flash_plan.route`` picks (bf16 at d 64 and 128: the wgmma kernels),
    in that order on the current stream. dq comes back laid out as (B, Sq,
    H, d) and dk, dv as
    (B, Sk, KV, d), so ``.transpose(1, 2)`` is the model layout without a
    copy. Keys at or past ``seq_k`` get zero gradients.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal, seq_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    global bwd_launches
    o = _bwd_operands(q, k, v, out, lse, do, causal, seq_k)
    if q.shape[2] == 0:
        return o["dq"], o["dk"].zero_(), o["dv"].zero_()
    for kernel in BWD_KERNELS:
        _launch_bwd(kernel, o)
    with _build.COUNT_LOCK:
        bwd_launches += 1
        bwd_route_launches[o["plan"].route] += 1
    return o["dq"], o["dk"], o["dv"]


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on head-major views: the forward
    kernel (or its plain version) forward, the backward kernels (or their
    plain version) backward, from the saved q, k, v, out and lse. Under
    ``inference_mode`` or ``no_grad`` it records nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, seq_k: int | None = None):
        out, lse = flash_attention(q, k, v, causal, seq_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.seq_k = causal, seq_k
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal, ctx.seq_k)
        return dq, dk, dv, None, None
