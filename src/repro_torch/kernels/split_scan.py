"""Split-gain surface: CUDA kernel wrapper and its plain version.

Replaces ``repro.kernels.split_scan.split_gain_pallas``. The kernel
(``csrc/split_scan.cu``) says what bounds it and how its design answers
that. A CPU tensor runs ``split_gain_plain``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches, counted where the kernel is launched

split_gain_plain = ref.split_gain_surface_ref  # the plain PyTorch version


def split_gain(hist: torch.Tensor, lam: float, min_child_hess: float) -> torch.Tensor:
    """Gain surface (L, F, B) f32 from (2, L, F, B) histograms; -inf where
    a child's hessian mass is under ``min_child_hess`` and at the last bin."""
    if hist.device.type == "cpu":
        return split_gain_plain(hist, lam, min_child_hess)
    if hist.device.type != "cuda":
        raise ValueError(f"split_gain: no kernel for device {hist.device}")
    global launches
    _, l, f, b = hist.shape
    _build.require(hist, "hist", torch.float32, (2, l, f, b), hist.device)
    if not 1 <= b <= 256:
        raise ValueError(f"split_gain kernel takes 1..256 bins, got {b}")
    out = torch.empty((l, f, b), dtype=torch.float32, device=hist.device)
    if out.numel() == 0:
        return out
    fn = _build.function(
        "split_scan", "split_gain_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(hist.data_ptr(), out.data_ptr(), l * f, b, lam, min_child_hess,
             _build.stream_of(hist.device))
    _build.check(err, "split_gain kernel")
    launches += 1
    return out
