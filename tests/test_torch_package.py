"""Package rules of the PyTorch/CUDA port.

* Nothing under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or the JAX package ``repro`` (only tests import both).
* Entry points run on the card unless given a device; without a GPU and
  without a device they raise instead of carrying on on the CPU.
* Kernel modules import without a CUDA toolkit: nothing is built until a
  kernel is launched.
"""
import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import binned_from_numpy, forest_from_numpy, sparse_from_numpy
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.ps.engine import Trainer
from repro_torch.serving.forest_server import ForestServer
from repro_torch.trees.binning import bin_dataset, to_sparse
from repro_torch.trees.forest import empty_forest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_files_were_found():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "engine.py", "histogram.py", "forest_server.py",
            "level_build.py", "histogram_sparse.py"} <= names


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.histogram", "repro_torch.kernels.split_scan",
    "repro_torch.kernels.forest_traversal", "repro_torch.kernels.ops",
    "repro_torch.kernels.level_build", "repro_torch.kernels.histogram_sparse",
])
def test_kernel_modules_import_without_a_build(module, monkeypatch):
    from repro_torch.kernels import _build

    def refuse():
        raise AssertionError("a kernel was built at import time")

    monkeypatch.setattr(_build, "build_all", refuse)
    importlib.reload(importlib.import_module(module))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_gpu(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_trainer_without_device_raises_without_gpu(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(SGBDTConfig())
    assert Trainer(SGBDTConfig(), device="cpu").device == torch.device("cpu")


def test_server_without_device_raises_without_gpu(no_cuda):
    forest = empty_forest(4, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ForestServer(forest, torch.zeros((3, 7)))
    assert ForestServer(forest, torch.zeros((3, 7)), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("make", [
    lambda: bin_dataset(np.zeros((4, 2), np.float32), np.zeros(4, np.float32), 8),
    lambda: empty_forest(4, 2),
    lambda: forest_from_numpy(np.zeros((1, 1)), np.zeros((1, 1)), np.zeros((1, 2)), 1, 0.0),
    lambda: binned_from_numpy(np.zeros((2, 1)), np.zeros((1, 7)), np.zeros(2), np.ones(2), 8),
    lambda: sparse_from_numpy(*[np.zeros((2, 1))] * 4, np.zeros(1)),
    lambda: to_sparse(np.zeros((2, 1))),
])
def test_data_entry_points_without_device_raise_without_gpu(no_cuda, make):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_trainer_refuses_data_on_another_device():
    data = bin_dataset(np.zeros((4, 2), np.float32), np.zeros(4, np.float32), 8,
                       device="cpu")
    trainer = Trainer(SGBDTConfig(n_trees=1), device="meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        trainer.train(data)
