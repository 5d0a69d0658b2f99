"""Turn the JAX package's parameters, given as numpy arrays, into the port's.

Callers pass ``np.asarray`` of a reference ``Forest``, ``BinnedData`` or
``SparseBins`` field by field, a language model's parameter tree as
nested dicts of numpy arrays, or an optimizer state with numpy leaves, so
both packages compute on the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import entry_dtype, map_schema, param_schema
from repro_torch.optim.delayed import DelayedState
from repro_torch.optim.optimizers import AdamState, SgdState, tree_leaves
from repro_torch.trees.binning import BinnedData, SparseBins
from repro_torch.trees.forest import Forest, QuantizedForest


def _tensor(a, dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype), device=dev)  # a writable copy


def _from_numpy(a) -> torch.Tensor:
    """A CPU tensor of ``a``'s values and dtype, bfloat16 (``ml_dtypes``,
    which numpy does not know) included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def forest_from_numpy(
    feature, threshold, leaf_value, n_trees, base_score,
    device: str | torch.device | None = None,
) -> Forest:
    """A ``Forest`` (f32 layout) from numpy arrays; ``base_score`` keeps its
    shape: () for one output, (K,) for K."""
    dev = resolve_device(device)

    return Forest(
        feature=_tensor(feature, np.int32, dev),
        threshold=_tensor(threshold, np.int32, dev),
        leaf_value=_tensor(leaf_value, np.float32, dev),
        n_trees=_tensor(n_trees, np.int32, dev).reshape(()),
        base_score=_tensor(base_score, np.float32, dev),
    )


def quantized_forest_from_numpy(
    feature, threshold, leaf_value, leaf_scale, n_trees, base_score,
    device: str | torch.device | None = None,
) -> QuantizedForest:
    """A ``QuantizedForest`` from numpy arrays (the reference's six fields):
    thresholds stay int8 or int16 and leaves int8 or float16, as packed."""
    dev = resolve_device(device)
    threshold, leaf_value = np.asarray(threshold), np.asarray(leaf_value)
    if (threshold.dtype, leaf_value.dtype) not in ((np.int8, np.int8),
                                                   (np.int16, np.float16)):
        raise TypeError(f"quantized forest of {threshold.dtype} thresholds and "
                        f"{leaf_value.dtype} leaves: expected int8/int8 or int16/float16")
    return QuantizedForest(
        feature=_tensor(feature, np.int32, dev),
        threshold=_tensor(threshold, threshold.dtype, dev),
        leaf_value=_tensor(leaf_value, leaf_value.dtype, dev),
        leaf_scale=_tensor(leaf_scale, np.float32, dev),
        n_trees=_tensor(n_trees, np.int32, dev).reshape(()),
        base_score=_tensor(base_score, np.float32, dev),
    )


def binned_from_numpy(
    bins, bin_edges, labels, multiplicity, n_bins: int,
    device: str | torch.device | None = None, qid=None,
) -> BinnedData:
    """A dense ``BinnedData`` from numpy arrays (``qid``: query ids, or
    None)."""
    dev = resolve_device(device)

    return BinnedData(
        bins=_tensor(bins, np.int32, dev),
        bin_edges=_tensor(bin_edges, np.float32, dev),
        labels=_tensor(labels, np.float32, dev),
        multiplicity=_tensor(multiplicity, np.float32, dev),
        n_bins=int(n_bins),
        qid=None if qid is None else _tensor(qid, np.int32, dev),
    )


def sparse_from_numpy(
    indices, codes, feat_rows, feat_codes, zero_bin,
    device: str | torch.device | None = None,
) -> SparseBins:
    """A ``SparseBins`` from numpy arrays (the reference's five fields)."""
    dev = resolve_device(device)

    return SparseBins(*(_tensor(a, np.int32, dev) for a in
                        (indices, codes, feat_rows, feat_codes, zero_bin)))


def lm_params_from_numpy(
    cfg: ModelConfig, params: dict, device: str | torch.device | None = None,
) -> dict:
    """The port's parameter tree from the reference's, name for name (both
    follow ``param_schema``: stacked (L, ...) layers, ``x @ w`` layouts).
    Leaves are numpy arrays, bfloat16 ones included (``ml_dtypes``); each
    must have its entry's shape and becomes a tensor of its entry's dtype
    (``transformer.entry_dtype``: ``cfg.dtype``, but f32 for a Mamba2
    layer's ``a_log`` and ``dt_bias``)."""
    dev = resolve_device(device)

    def leaf(path, entry):
        a = params
        for name in path:
            a = a[name]
        a = np.asarray(a)
        if tuple(a.shape) != tuple(entry.shape):
            raise ValueError(f"{'.'.join(path)}: shape {a.shape}, expected {entry.shape}")
        return _from_numpy(a).to(device=dev, dtype=entry_dtype(cfg, entry))

    return map_schema(leaf, param_schema(cfg))


def opt_state_from_numpy(cfg: ModelConfig, opt_state, params_t: dict):
    """The port's optimizer state from the reference's, with numpy leaves
    (``jax.tree.map(np.asarray, state)``): ``AdamState``, ``SgdState`` and
    ``DelayedState`` become the port's NamedTuples of the same name, tuples
    (``chain``) stay tuples, and leaves keep their own dtype (bfloat16
    included: an f32 ``a_log`` moment stays f32 in a bf16 model) on the
    device of ``params_t``. Every moment tree must have
    ``param_schema(cfg)``'s shapes; a delayed ring leaf has the delay in
    front."""
    dev = tree_leaves(params_t)[0].device

    def tensor(a) -> torch.Tensor:
        return _from_numpy(a).to(dev)

    def tree(t, lead: tuple = ()) -> dict:
        def leaf(path, entry):
            a = t
            for name in path:
                a = a[name]
            if tuple(np.shape(a)) != lead + tuple(entry.shape):
                raise ValueError(f"{'.'.join(path)}: shape {np.shape(a)}, expected "
                                 f"{lead + tuple(entry.shape)}")
            return tensor(a)
        return map_schema(leaf, param_schema(cfg))

    def convert(s):
        name = type(s).__name__
        if name == "AdamState":
            return AdamState(step=tensor(s.step), mu=tree(s.mu), nu=tree(s.nu))
        if name == "SgdState":
            return SgdState(momentum=tree(s.momentum) if len(s.momentum) else ())
        if name == "DelayedState":
            delay = tree_leaves(s.ring)[0].shape[0]
            return DelayedState(step=tensor(s.step), ring=tree(s.ring, (delay,)),
                                inner=convert(s.inner))
        if type(s) is tuple:  # a chain's states
            return tuple(convert(x) for x in s)
        raise TypeError(f"opt_state_from_numpy: no port twin of {name}")

    return convert(opt_state)
