"""Batched forest traversal: CUDA kernel wrapper and its plain version.

Replaces ``repro.kernels.forest_traversal.forest_traverse_pallas`` in each
of its forms: the f32 layout, the quantized layouts of ``Forest.quantize``
(int8 thresholds with int8 leaves times a per-tree scale; int16 thresholds
with fp16 leaves) and K > 1 outputs (slot t adds into column t % K). The
kernels (``csrc/forest_traversal.cu``) say what bounds them and how their
design answers that; their launch plan is ``kernels/traversal_plan.py``. A
CPU tensor runs ``forest_traverse_plain``; a CUDA tensor launches the
kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref, traversal_plan

# Kernel launches by form, counted where the kernel is launched: the
# layout's name ("f32", "int8", "fp16") with one output, "k_" and the name
# with K > 1.
form_launches = {f"{k}{q}": 0 for k in ("", "k_") for q in ("f32", "int8", "fp16")}

MAX_DEPTH = 10  # the deepest tree the kernel walks
MAX_OUTPUTS = 64  # the most columns the sum kernel takes

# (threshold dtype, leaf dtype) -> the kernel's layout code and name.
_LAYOUTS = {
    (torch.int32, torch.float32): (0, "f32"),
    (torch.int8, torch.int8): (1, "int8"),
    (torch.int16, torch.float16): (2, "fp16"),
}


def _layout(threshold: torch.Tensor, leaf_value: torch.Tensor) -> tuple[int, str]:
    key = (threshold.dtype, leaf_value.dtype)
    if key not in _LAYOUTS:
        raise TypeError(f"forest_traverse: {key[0]} thresholds with {key[1]} leaves; the "
                        "layouts are int32/float32, int8/int8 and int16/float16")
    return _LAYOUTS[key]


def forest_traverse_plain(
    bins: torch.Tensor,
    feature: torch.Tensor,
    threshold: torch.Tensor,
    leaf_value: torch.Tensor,
    n_trees: torch.Tensor | int,
    depth: int,
    n_outputs: int = 1,
    leaf_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version: dequantize up front, then sum tree by tree
    in slot order into column t % K, the sum the kernel takes (so the two
    agree bit for bit)."""
    return ref.apply_forest_ref(bins, feature, threshold, leaf_value, depth, n_trees,
                                n_outputs=n_outputs, leaf_scale=leaf_scale)


def forest_traverse(
    bins: torch.Tensor,  # (N, F) int32
    feature: torch.Tensor,  # (T, 2^d - 1) int32, ids in [0, F)
    threshold: torch.Tensor,  # (T, 2^d - 1) int32; int8 or int16 quantized
    leaf_value: torch.Tensor,  # (T, 2^d) f32; int8 or fp16 quantized
    n_trees: torch.Tensor | int,  # live slots; slots >= n_trees add 0
    depth: int,
    n_outputs: int = 1,
    leaf_scale: torch.Tensor | None = None,  # (T,) f32, int8 leaves only
) -> torch.Tensor:
    """Masked forest sum (N,) f32, or (N, K) with ``n_outputs`` = K > 1."""
    _layout(threshold, leaf_value)  # raises on a pairing no kernel takes
    if bins.device.type == "cpu":
        return forest_traverse_plain(bins, feature, threshold, leaf_value, n_trees, depth,
                                     n_outputs, leaf_scale)
    if bins.device.type != "cuda":
        raise ValueError(f"forest_traverse: no kernel for device {bins.device}")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"forest_traverse kernel takes depth 0..{MAX_DEPTH}, got {depth}")
    if not 1 <= n_outputs <= MAX_OUTPUTS:
        raise ValueError(f"forest_traverse kernel takes 1..{MAX_OUTPUTS} outputs, "
                         f"got {n_outputs}")
    dev = bins.device
    n, f = bins.shape
    t = feature.shape[0]
    n_int, n_leaf = (1 << depth) - 1, 1 << depth
    n_trees = torch.as_tensor(n_trees, dtype=torch.int32, device=dev).reshape(())
    _build.require(bins, "bins", torch.int32, (n, f), dev)
    _build.require(feature, "feature", torch.int32, (t, n_int), dev)
    _build.require(threshold, "threshold", threshold.dtype, (t, n_int), dev)
    _build.require(leaf_value, "leaf_value", leaf_value.dtype, (t, n_leaf), dev)
    if leaf_value.dtype == torch.int8:
        if leaf_scale is None:
            raise ValueError("int8 leaf_value needs a per-tree leaf_scale")
        _build.require(leaf_scale, "leaf_scale", torch.float32, (t,), dev)
    shape = (n,) if n_outputs == 1 else (n, n_outputs)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    p = traversal_plan.plan(n, f, t, depth, leaf_value.element_size(), _sms(dev))
    launch(p, bins, feature, threshold, leaf_value, n_trees, depth, n_outputs, leaf_scale, out)
    return out


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch(p: traversal_plan.TraversalPlan, bins, feature, threshold, leaf_value,
           n_trees: torch.Tensor, depth: int, n_outputs: int, leaf_scale, out) -> None:
    """Launch the kernels under plan ``p`` on validated CUDA tensors (the
    wrapper's checks above) into ``out``; the C entry point checks the plan
    again. Counts one launch of the form."""
    layout, name = _layout(threshold, leaf_value)
    n, f = bins.shape
    t = feature.shape[0]
    scratch = torch.empty(p.scratch_bytes, dtype=torch.uint8, device=bins.device)
    fn = _build.function(
        "forest_traversal", "forest_traverse_launch",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_longlong, ctypes.c_void_p],
    )
    err = fn(
        bins.data_ptr(), feature.data_ptr(), threshold.data_ptr(), leaf_value.data_ptr(),
        None if leaf_scale is None else leaf_scale.data_ptr(), n_trees.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), n, f, t, depth, n_outputs, layout, p.samples,
        p.threads, p.group, p.chunk, p.ahead, p.slab, p.row_bytes, p.scratch_bytes,
        _build.stream_of(bins.device),
    )
    _build.check(err, "forest_traverse kernel")
    with _build.COUNT_LOCK:
        form_launches[("k_" if n_outputs > 1 else "") + name] += 1
