"""Filesystem checkpointing for trees of tensors (twin of
``repro.checkpoint.store``), on the same disk format:

    <root>/step_000123/
        manifest.json     # leaf paths, shapes, dtypes, CRC32s
        leaf_00000.npy    # one .npy per leaf (host numpy)
        ...

A checkpoint written by either package opens in the other: leaf paths and
their order are those of ``jax.tree_util.tree_flatten_with_path`` (``_flatten``
repeats them), bf16 leaves are stored as their 16-bit patterns with
``"dtype": "bfloat16"``, and a Python ``int`` leaf (``TrainState.step``) as
the 0-d int32 the reference keeps there. Writes are atomic (temporary
directory, then a rename); restores check shapes and, on request, CRCs;
``CheckpointManager`` keeps the newest K steps.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import shutil
import zlib

import numpy as np
import torch

from repro_torch import resolve_device

# torch dtypes by the numpy name the manifest records.
_DTYPES = {"bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
           "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs in ``tree_flatten_with_path`` order and spelling:
    ``.name`` for a NamedTuple field (field order), ``['key']`` for a dict
    key (sorted; an OrderedDict keeps its order), ``[i]`` for a list or
    tuple item; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{name}", getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, dict):
        keys = tree if isinstance(tree, collections.OrderedDict) else sorted(tree)
        items = [(f"[{k!r}]", tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += _flatten(sub, f"{prefix}/{key}" if prefix else key)
    return out


def _unflatten(like, leaves):
    """``like`` with its leaves replaced, in ``_flatten`` order, from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, dict):
        keys = like if isinstance(like, collections.OrderedDict) else sorted(like)
        out = {k: _unflatten(like[k], leaves) for k in keys}
        return type(like)((k, out[k]) for k in like)
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf's host array as stored, and its logical dtype name: bf16 as
    its bit patterns (uint16), a Python int as int32 and a float as float32
    (as the reference holds them)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bf16: through an int16 view
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _NAMES[t.dtype]
    if isinstance(leaf, bool):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        arr = np.asarray(leaf, np.float32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(root: str | pathlib.Path, step: int, tree, *, crc: bool = True) -> pathlib.Path:
    """Atomically save ``tree`` under ``root/step_<step>``; device leaves are
    copied to the host first."""
    root = pathlib.Path(root)
    final = root / f"step_{step:06d}"
    tmp = root / f".tmp_step_{step:06d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        entry = {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype}
        if crc:
            entry["crc32"] = zlib.crc32(arr.tobytes())
        manifest["leaves"].append(entry)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a host tensor of its logical dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_pytree(root: str | pathlib.Path, step: int, like, *, check_crc: bool = False,
                   device: str | torch.device | None = None):
    """Restore into the structure, leaf shapes and dtypes of ``like``.

    A tensor leaf of ``like`` gives its device to the restored leaf; any
    other leaf (numpy, a Python number) goes to ``device``, the card unless
    one is given. Python ``int`` and ``float`` leaves come back as such.
    """
    d = step_dir(root, step)
    manifest = json.loads((d / "manifest.json").read_text())
    entries = {e["path"]: e for e in manifest["leaves"]}
    flat = _flatten(like)
    dev = None
    if not all(isinstance(leaf, (torch.Tensor, bool, int, float)) for _, leaf in flat):
        dev = resolve_device(device)
    out = []
    for path, leaf in flat:
        e = entries.get(path)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = np.load(d / e["file"])
        want_shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if arr.shape != want_shape:
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != expected {want_shape}")
        if check_crc and "crc32" in e and zlib.crc32(arr.tobytes()) != e["crc32"]:
            raise ValueError(f"{path}: CRC mismatch (corrupt checkpoint)")
        t = _as_tensor(arr, e["dtype"])
        if isinstance(leaf, torch.Tensor):
            out.append(t.to(dtype=leaf.dtype, device=leaf.device))
        elif isinstance(leaf, (bool, int, float)):
            out.append(type(leaf)(t.item()))
        else:
            dtype = _DTYPES[str(np.asarray(leaf).dtype)]
            out.append(t.to(dtype=dtype, device=dev))
    return _unflatten(like, iter(out))


def _step_entries(root: pathlib.Path) -> list[tuple[int, pathlib.Path]]:
    """``(step, path)`` for every ``step_<digits>`` directory, by step.

    A checkpoint root is shared: a foreign ``step_final/``, an editor's
    ``step_backup``, a stray file. Anything whose suffix is not all digits
    is somebody else's and is skipped.
    """
    out = []
    for p in root.iterdir():
        suffix = p.name[5:]
        if p.name.startswith("step_") and suffix.isdigit() and p.is_dir():
            out.append((int(suffix), p))
    out.sort()
    return out


def step_dir(root: str | pathlib.Path, step: int) -> pathlib.Path:
    """The directory holding ``step``: the zero-padded name, or any numeric
    ``step_*`` entry of the same value (``latest_step`` reports unpadded
    ones, so every loader opens them)."""
    root = pathlib.Path(root)
    canonical = root / f"step_{step:06d}"
    if canonical.exists() or not root.exists():
        return canonical
    for s, p in _step_entries(root):
        if s == step:
            return p
    return canonical  # missing either way; the caller's read raises


def steps(root: str | pathlib.Path) -> list[int]:
    """Every complete checkpoint step under ``root`` (its manifest written),
    ascending."""
    root = pathlib.Path(root)
    if not root.exists():
        return []
    return [s for s, p in _step_entries(root) if (p / "manifest.json").exists()]


def latest_step(root: str | pathlib.Path) -> int | None:
    all_steps = steps(root)
    return all_steps[-1] if all_steps else None


def leaf_manifest(root: str | pathlib.Path, step: int) -> dict[str, dict]:
    """The manifest's leaf entries by path: shapes and dtypes without
    loading any array, so a caller can size ``like`` for variable-size
    leaves first."""
    manifest = json.loads((step_dir(root, step) / "manifest.json").read_text())
    return {e["path"]: e for e in manifest["leaves"]}


@dataclasses.dataclass
class CheckpointManager:
    """Save every K steps, keep the newest ``keep``."""

    root: str | pathlib.Path
    save_every: int = 100
    keep: int = 3

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.save_every != 0:
            return False
        save_pytree(self.root, step, tree)
        self._gc()
        return True

    def restore_latest(self, like, device: str | torch.device | None = None):
        step = latest_step(self.root)
        if step is None:
            return None, None
        return step, restore_pytree(self.root, step, like, device=device)

    def _gc(self) -> None:
        # Remove by each entry's own path (step_7 is step 7 unpadded too);
        # foreign step_* entries are never listed.
        for _, p in _step_entries(pathlib.Path(self.root))[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
