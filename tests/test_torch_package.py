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
import repro_torch.configs as configs
from repro_torch.convert import (
    binned_from_numpy,
    forest_from_numpy,
    lm_params_from_numpy,
    quantized_forest_from_numpy,
    sparse_from_numpy,
)
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.data.synthetic import (
    make_multiclass_classification,
    make_ranking,
    make_sparse_regression,
)
from repro_torch import checkpoint
from repro_torch.configs import gbdt as gbdt_configs
from repro_torch.launch import serve as gbdt_serve
from repro_torch.launch import train as lm_train
from repro_torch.models import init_cache, init_params
from repro_torch.ps.engine import Trainer
from repro_torch.serving import ForestEngine, ServingEngine
from repro_torch.serving.forest_server import ForestServer, load_forest_checkpoint
from repro_torch.trees.binning import bin_dataset, to_sparse
from repro_torch.trees.forest import empty_forest
from repro_torch.trees.tree import empty_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_CKPT = ROOT / "tests" / "golden" / "ckpt"
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
            "level_build.py", "histogram_sparse.py", "flash_attention.py", "transformer.py",
            "layers.py", "granite_3_2b.py", "steps.py", "train.py", "optimizers.py",
            "delayed.py", "store.py", "continuous.py", "serve.py", "gbdt.py",
            "regression.py", "ranking.py", "losses.py", "schedules.py", "runtime.py",
            "worker.py", "async_sgbdt.py", "simulator.py", "collectives.py", "mesh.py",
            "rules.py", "sharded.py", "baselines.py", "ssm.py", "zamba2_1_2b.py",
            "pipeline.py", "policy.py"} <= names


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.histogram", "repro_torch.kernels.split_scan",
    "repro_torch.kernels.forest_traversal", "repro_torch.kernels.ops",
    "repro_torch.kernels.level_build", "repro_torch.kernels.histogram_sparse",
    "repro_torch.kernels.flash_attention", "repro_torch.models.transformer",
    "repro_torch.launch.steps", "repro_torch.launch.train", "repro_torch.optim.optimizers",
    "repro_torch.launch.serve", "repro_torch.serving.continuous",
    "repro_torch.checkpoint.store", "repro_torch.configs.gbdt",
    "repro_torch.trees.losses", "repro_torch.ps.schedules", "repro_torch.ps.runtime",
    "repro_torch.ps.worker", "repro_torch.core.async_sgbdt", "repro_torch.core.simulator",
    "repro_torch.collectives", "repro_torch.launch.mesh", "repro_torch.sharding.rules",
    "repro_torch.ps.sharded", "repro_torch.core.baselines", "repro_torch.models.ssm",
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


@pytest.mark.parametrize("quantize", ["int8", "fp16"])
def test_quantized_server_without_device_raises_without_gpu(no_cuda, quantize):
    forest = empty_forest(4, 2, n_outputs=3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ForestServer(forest, torch.zeros((3, 7)), quantize=quantize)
    server = ForestServer(forest, torch.zeros((3, 7)), device="cpu", quantize=quantize)
    assert server.device.type == "cpu" and server.forest.mode == quantize


def test_serving_engine_without_device_raises_without_gpu(no_cuda):
    cfg = configs.get("granite-3-2b").reduced()
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    assert ServingEngine(cfg, params, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda: init_params(configs.get("granite-3-2b").reduced()),
    lambda: init_cache(configs.get("granite-3-2b").reduced(), 1, 8),
    lambda: init_params(configs.get("zamba2-1.2b").reduced()),
    lambda: init_cache(configs.get("zamba2-1.2b").reduced(), 1, 8),
    lambda: lm_params_from_numpy(configs.get("granite-3-2b").reduced(), {}),
    lambda: bin_dataset(np.zeros((4, 2), np.float32), np.zeros(4, np.float32), 8),
    lambda: empty_forest(4, 2),
    lambda: forest_from_numpy(np.zeros((1, 1)), np.zeros((1, 1)), np.zeros((1, 2)), 1, 0.0),
    lambda: binned_from_numpy(np.zeros((2, 1)), np.zeros((1, 7)), np.zeros(2), np.ones(2), 8),
    lambda: sparse_from_numpy(*[np.zeros((2, 1))] * 4, np.zeros(1)),
    lambda: to_sparse(np.zeros((2, 1))),
    lambda: next(lm_train.synthetic_batches(configs.get("granite-3-2b").reduced(), 1, 4, 1)),
    lambda: empty_forest(4, 2, n_outputs=3),
    lambda: empty_tree(2),
    lambda: make_multiclass_classification(20, 3, 3),
    lambda: quantized_forest_from_numpy(np.zeros((1, 1)), np.zeros((1, 1), np.int8),
                                        np.zeros((1, 2), np.int8), np.ones(1), 1, 0.0),
    lambda: lm_train.main(["--steps", "1"]),
    lambda: lm_train.main(["--arch", "gbdt", "--steps", "1"]),
    lambda: gbdt_serve.main(["--arch", "gbdt", "--trees", "2"]),
    lambda: gbdt_serve.main(["--arch", "phi3.5-moe-42b"]),
    lambda: ForestEngine(torch.zeros((3, 7))),
    lambda: load_forest_checkpoint(GOLDEN_CKPT, 8),
    lambda: checkpoint.restore_pytree(GOLDEN_CKPT, 8, {"f": np.zeros(320, np.float32)}),
    lambda: gbdt_configs.get("validity-higgs"),
    lambda: gbdt_configs.get("efficiency-e2006"),
    lambda: make_ranking(4, 4, 3),
    lambda: make_sparse_regression(20, 10, 2),
    lambda: bin_dataset(np.zeros((4, 2), np.float32), np.zeros(4, np.float32), 8,
                        qid=np.zeros(4, np.int32)),
    lambda: binned_from_numpy(np.zeros((2, 1)), np.zeros((1, 7)), np.zeros(2), np.ones(2), 8,
                              qid=np.zeros(2)),
    lambda: lm_train.main(["--arch", "gbdt", "--steps", "1", "--objective", "mse"]),
    lambda: lm_train.main(["--arch", "gbdt", "--steps", "1", "--objective", "lambdarank"]),
    lambda: gbdt_serve.main(["--arch", "gbdt", "--trees", "2", "--objective", "lambdarank"]),
    lambda: Trainer(SGBDTConfig(step_kind="newton", adaptive_step=0.1)),
    lambda: lm_train.main(["--arch", "gbdt", "--steps", "1", "--runtime", "threads"]),
    lambda: lm_train.main(["--arch", "gbdt", "--steps", "1", "--scan"]),
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
