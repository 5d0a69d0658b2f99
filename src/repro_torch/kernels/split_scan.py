"""Split-gain surface and each node's decision: CUDA kernel wrapper and its
plain version.

Replaces ``repro.kernels.split_scan.split_gain_pallas``; its decision form
also takes over the masked first-max argmax the staged level ran after it
(``repro.trees.learner``). The kernel (``csrc/split_scan.cu``) says what
bounds it and how its design answers that. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches, counted where the kernel is launched

split_gain_plain = ref.split_gain_surface_ref  # the plain PyTorch version


def split_gain_decide_plain(
    hist: torch.Tensor, lam: float, min_child_hess: float, mask_i32: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of ``split_gain_decide``: the surface, the mask,
    the first maximum and its gain, as the reference's staged level takes
    them."""
    gain = split_gain_plain(hist, lam, min_child_hess)
    flat = gain.masked_fill((mask_i32 == 0)[None, :, None], float("-inf")).reshape(
        gain.shape[0], -1)
    idx = torch.argmax(flat, dim=-1)  # the first maximum, as jnp.argmax
    best = flat.gather(1, idx[:, None])[:, 0]
    return gain, best, idx


# (device, stream handle) -> the decision's scratch words on that stream,
# zero between launches. Two streams' launches must not share the keys and
# ticket, so each stream keeps its own.
_WORK: dict = {}  # guarded-by: _WORK_LOCK
_WORK_LOCK = threading.Lock()


def _workspace(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """At least ``words`` zeroed 64-bit words of the decision's scratch for
    launches on ``stream``: each node's key, then the ticket. The kernel
    leaves them zero, so one buffer serves every launch on that stream in
    turn with no memset a level; a larger level zeroes a larger one once,
    allocated on that stream."""
    with _WORK_LOCK:
        work = _WORK.get((device, stream))
        if work is None or work.numel() < words:
            work = _WORK[device, stream] = torch.zeros(max(words, 1024), dtype=torch.int64,
                                                      device=device)
        return work


def _launch(hist, lam, min_child_hess, mask_i32):
    """One launch of the kernel: the surface, and with a mask the decision."""
    global launches
    _, l, f, b = hist.shape
    _build.require(hist, "hist", torch.float32, (2, l, f, b), hist.device)
    if not 1 <= b <= 256:
        raise ValueError(f"split_gain kernel takes 1..256 bins, got {b}")
    out = torch.empty((l, f, b), dtype=torch.float32, device=hist.device)
    stream = _build.stream_of(hist.device)
    best = idx = work = None
    if mask_i32 is not None:
        _build.require(mask_i32, "mask_i32", torch.int32, (f,), hist.device)
        if f * b > 1 << 30:
            raise ValueError(f"split_gain_decide kernel takes F x B <= 2^30, got {f * b}")
        best = torch.empty(l, dtype=torch.float32, device=hist.device)
        idx = torch.empty(l, dtype=torch.int64, device=hist.device)
        work = _workspace(hist.device, stream, l + 1)
    if out.numel() == 0:
        if best is not None:
            best.fill_(float("-inf"))
            idx.zero_()
        return out, best, idx
    fn = _build.function(
        "split_scan", "split_gain_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    )
    ptr = [t.data_ptr() if t is not None else None for t in (mask_i32, work, best, idx)]
    err = fn(hist.data_ptr(), out.data_ptr(), *ptr, l, f, b, lam, min_child_hess, stream)
    _build.check(err, "split_gain kernel")
    with _build.COUNT_LOCK:
        launches += 1
    return out, best, idx


def _device(hist: torch.Tensor, what: str) -> None:
    if hist.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {hist.device}")


def split_gain(hist: torch.Tensor, lam: float, min_child_hess: float) -> torch.Tensor:
    """Gain surface (L, F, B) f32 from (2, L, F, B) histograms; -inf where
    a child's hessian mass is under ``min_child_hess`` and at the last bin."""
    if hist.device.type == "cpu":
        return split_gain_plain(hist, lam, min_child_hess)
    _device(hist, "split_gain")
    return _launch(hist, lam, min_child_hess, None)[0]


def split_gain_decide(
    hist: torch.Tensor, lam: float, min_child_hess: float, mask_i32: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gain (L, F, B) f32 as ``split_gain`` gives it, best (L,) f32, idx
    (L,) int64): each node's first maximum over its F*B cells with the
    features where ``mask_i32`` ((F,) int32) is 0 counted as -inf; a node
    whose cells are all -inf gets idx 0 and -inf, as ``torch.argmax``."""
    if hist.device.type == "cpu":
        return split_gain_decide_plain(hist, lam, min_child_hess, mask_i32)
    _device(hist, "split_gain_decide")
    return _launch(hist, lam, min_child_hess, mask_i32)
