"""The port's checkpoint store against the JAX package's, on one disk format.

A checkpoint written by either package restores in the other bit for bit
(a GBDT ``TrainState`` with one output and with three, a bf16 LM parameter
tree), both write the same ``manifest.json`` for the same values (paths,
shapes, dtypes, CRCs), the port opens the committed golden checkpoint and
serves it to the committed scores (rtol/atol 1e-5, as ``test_golden.py``),
and the reference's failure cases hold in the port too.
"""
import dataclasses
import importlib.util
import json
import pathlib
import zlib

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as JM
from repro import checkpoint as jckpt
from repro.core.sgbdt import TrainState as JTrainState
from repro.trees.forest import Forest as JForest
from repro_torch import checkpoint as tckpt
import repro_torch.configs as tconfigs
from repro_torch.convert import forest_from_numpy, lm_params_from_numpy
from repro_torch.core.sgbdt import TrainState
from repro_torch.serving.forest_server import ForestServer, PredictRequest, load_forest_checkpoint

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_regen", GOLDEN / "regen.py")
regen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(regen)


def _state_arrays(k: int, seed: int = 0) -> dict:
    """A trained-looking GBDT state as numpy: 6 slots of depth 3, K outputs."""
    rng = np.random.default_rng(seed + k)
    slots = 6 * k
    return {
        "feature": rng.integers(0, 11, (slots, 7)).astype(np.int32),
        "threshold": rng.integers(0, 64, (slots, 7)).astype(np.int32),
        "leaf_value": rng.standard_normal((slots, 8)).astype(np.float32),
        "n_trees": np.asarray(4 * k, np.int32),
        "base_score": (rng.standard_normal(k) if k > 1 else np.asarray(0.25)).astype(np.float32),
        "f": rng.standard_normal((50, k) if k > 1 else (50,)).astype(np.float32),
        "step": 4,
    }


def _port_state(a: dict) -> TrainState:
    forest = forest_from_numpy(a["feature"], a["threshold"], a["leaf_value"], a["n_trees"],
                               a["base_score"], device="cpu")
    return TrainState(forest=forest, f=torch.from_numpy(a["f"]), step=a["step"])


def _jax_state(a: dict) -> JTrainState:
    forest = JForest(*(jax.numpy.asarray(a[n]) for n in
                       ("feature", "threshold", "leaf_value", "n_trees", "base_score")))
    return JTrainState(forest=forest, f=jax.numpy.asarray(a["f"]),
                       step=jax.numpy.asarray(a["step"], jax.numpy.int32))


def _lm_params():
    """A reduced granite-3-2b in bf16: the reference's init and the port's
    tree of the same values."""
    cfg_j = dataclasses.replace(jconfigs.get("granite-3-2b").reduced(), dtype="bfloat16")
    cfg_t = dataclasses.replace(tconfigs.get("granite-3-2b").reduced(), dtype="bfloat16")
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    return params_j, params_t


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (bf16 too) from either package."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().reshape(-1).view(np.uint8)
    if isinstance(x, int):
        return np.asarray([x], np.int32).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def _same(port_tree, jax_tree) -> None:
    flat_t = tckpt.store._flatten(port_tree)
    flat_j, _ = jax.tree_util.tree_flatten_with_path(jax_tree)
    assert [p for p, _ in flat_t] == ["/".join(str(k) for k in p) for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        assert np.array_equal(_bits(a), _bits(b)), path
        assert tuple(np.shape(a)) == tuple(np.shape(b)), path


@pytest.mark.parametrize("kind", ["state_k1", "state_k3", "lm_bf16"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_between_packages_bitwise(tmp_path, kind, writer):
    if kind == "lm_bf16":
        jtree, ttree = _lm_params()
    else:
        a = _state_arrays(int(kind[-1]))
        jtree, ttree = _jax_state(a), _port_state(a)
    if writer == "port":
        tckpt.save_pytree(tmp_path, 3, ttree)
        back = jckpt.restore_pytree(tmp_path, 3, jtree, check_crc=True)
        _same(ttree, back)
    else:
        jckpt.save_pytree(tmp_path, 3, jtree)
        back = tckpt.restore_pytree(tmp_path, 3, ttree, check_crc=True)
        _same(back, jtree)
        if kind != "lm_bf16":
            assert type(back.step) is int and back.step == 4
            assert back.forest.leaf_value.dtype == torch.float32


@pytest.mark.parametrize("kind", ["state_k1", "state_k3", "lm_bf16"])
def test_both_packages_write_the_same_manifest(tmp_path, kind):
    if kind == "lm_bf16":
        jtree, ttree = _lm_params()
    else:
        a = _state_arrays(int(kind[-1]))
        jtree, ttree = _jax_state(a), _port_state(a)
    tckpt.save_pytree(tmp_path / "port", 5, ttree)
    jckpt.save_pytree(tmp_path / "jax", 5, jtree)
    got = json.loads((tmp_path / "port" / "step_000005" / "manifest.json").read_text())
    want = json.loads((tmp_path / "jax" / "step_000005" / "manifest.json").read_text())
    assert got == want
    if kind != "lm_bf16":
        assert [(e["path"], e["dtype"]) for e in got["leaves"]][-2:] == [
            (".f", "float32"), (".step", "int32")]
    for e in got["leaves"]:  # the leaf files hold the same bytes too
        assert (tmp_path / "port" / "step_000005" / e["file"]).read_bytes() == \
               (tmp_path / "jax" / "step_000005" / e["file"]).read_bytes()


def test_port_opens_the_golden_checkpoint_and_serves_its_scores():
    data = regen.golden_data()
    manifest = tckpt.leaf_manifest(GOLDEN / "ckpt", regen.GOLDEN_STEP)
    like = TrainState(
        forest=forest_from_numpy(*(np.zeros(manifest[f".forest/.{n}"]["shape"]) for n in
                                   ("feature", "threshold", "leaf_value", "n_trees",
                                    "base_score")), device="cpu"),
        f=torch.zeros(tuple(manifest[".f"]["shape"])), step=0)
    state = tckpt.restore_pytree(GOLDEN / "ckpt", regen.GOLDEN_STEP, like, check_crc=True)
    assert state.step == regen.GOLDEN_STEP and int(state.forest.n_trees) == regen.GOLDEN_STEP
    served = load_forest_checkpoint(GOLDEN / "ckpt", regen.GOLDEN_STEP, device="cpu")
    for name in ("feature", "threshold", "leaf_value", "n_trees", "base_score"):
        assert torch.equal(getattr(served, name), getattr(state.forest, name)), name
    rows = np.load(GOLDEN / "eval_rows.npy")
    expected = np.load(GOLDEN / "expected_scores.npy")
    server = ForestServer(served, np.array(data.bin_edges), max_rows=32, device="cpu")
    (result,) = server.run([PredictRequest(uid=0, x=rows)])
    np.testing.assert_allclose(result.scores, expected, rtol=1e-5, atol=1e-5)


# The reference's failure cases (tests/test_checkpoint.py), in the port.

def _corrupt(tmp_path):
    tckpt.save_pytree(tmp_path, 0, {"w": torch.arange(16.0)})
    leaf = tmp_path / "step_000000" / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    tckpt.restore_pytree(tmp_path, 0, {"w": torch.arange(16.0)}, check_crc=True)


def _shape_mismatch(tmp_path):
    tckpt.save_pytree(tmp_path, 0, {"w": torch.zeros(4)})
    tckpt.restore_pytree(tmp_path, 0, {"w": torch.zeros(5)})


def _missing_leaf(tmp_path):
    tckpt.save_pytree(tmp_path, 0, {"w": torch.zeros(4)})
    tckpt.restore_pytree(tmp_path, 0, {"w": torch.zeros(4), "extra": torch.zeros(1)})


@pytest.mark.parametrize("case,error,match", [
    (_shape_mismatch, ValueError, "shape"),
    (_missing_leaf, KeyError, "extra"),
    (_corrupt, ValueError, "CRC"),
], ids=["shape_mismatch", "missing_leaf", "crc_corruption"])
def test_restore_rejects_a_bad_checkpoint(tmp_path, case, error, match):
    with pytest.raises(error, match=match):
        case(tmp_path)


def _retention(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, save_every=2, keep=2)
    tree = {"x": torch.zeros(3)}
    for step in range(1, 9):
        mgr.maybe_save(step, tree)
    assert tckpt.latest_step(tmp_path) == 8
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000006", "step_000008"]
    got_step, got = mgr.restore_latest(tree)
    assert got_step == 8 and torch.equal(got["x"], torch.zeros(3))


def _atomic_overwrite(tmp_path):
    tckpt.save_pytree(tmp_path, 3, {"w": torch.zeros(2)})
    tckpt.save_pytree(tmp_path, 3, {"w": torch.ones(2)})
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())
    back = tckpt.restore_pytree(tmp_path, 3, {"w": torch.zeros(2)})
    assert torch.equal(back["w"], torch.ones(2))


def _foreign_entries(tmp_path):
    tree = {"w": np.arange(4, dtype=np.float32)}
    mgr = tckpt.CheckpointManager(tmp_path, save_every=1, keep=2)
    for step in (1, 2, 3):
        mgr.maybe_save(step, tree)
    (tmp_path / "step_final").mkdir()
    (tmp_path / "step_final" / "manifest.json").write_text("{}")
    (tmp_path / "step_notes.txt").write_text("scratch")
    tckpt.save_pytree(tmp_path, 7, tree)
    (tmp_path / "step_000007").rename(tmp_path / "step_7")
    assert tckpt.latest_step(tmp_path) == 7  # unpadded numeric entries count
    assert tckpt.step_dir(tmp_path, 7).name == "step_7"
    step, restored = mgr.restore_latest(tree, device="cpu")
    assert step == 7 and np.array_equal(restored["w"].numpy(), tree["w"])
    mgr.maybe_save(8, tree)  # garbage collection over the shared root
    kept = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert "step_final" in kept and "step_notes.txt" in kept
    assert [n for n in kept if n[5:].isdigit()] == ["step_000008", "step_7"]
    assert tckpt.latest_step(tmp_path) == 8


def _steps_and_manifest(tmp_path):
    assert tckpt.steps(tmp_path / "nowhere") == []
    tree = {"f": torch.zeros(16), "held_f": torch.zeros((3, 16))}
    for s in (12, 4, 20):
        tckpt.save_pytree(tmp_path, s, tree)
    (tmp_path / "step_000009").mkdir()  # torn: no manifest
    assert tckpt.steps(tmp_path) == [4, 12, 20]
    held = tckpt.leaf_manifest(tmp_path, 12)["['held_f']"]
    assert held["shape"] == [3, 16] and held["dtype"] == "float32"
    like = {"f": torch.zeros(16), "held_f": torch.zeros(tuple(held["shape"]))}
    assert tckpt.restore_pytree(tmp_path, 12, like)["held_f"].shape == (3, 16)


@pytest.mark.parametrize("case", [_retention, _atomic_overwrite, _foreign_entries,
                                  _steps_and_manifest],
                         ids=["retention_and_latest", "atomic_overwrite",
                              "foreign_and_unpadded_entries", "steps_and_leaf_manifest"])
def test_store_keeps_the_reference_contracts(tmp_path, case):
    case(tmp_path)


def test_flatten_spells_paths_as_tree_flatten_with_path():
    tree = {"b": [1, (torch.zeros(2), None)], "a": {"z": 1.5, "y": torch.ones(1)},
            "c": _port_state(_state_arrays(1))}
    jtree = jax.tree.map(lambda x: np.asarray(x) if isinstance(x, torch.Tensor) else x, tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    want = ["/".join(str(k) for k in p) for p, _ in flat]
    assert [p for p, _ in tckpt.store._flatten(tree)] == want


def test_restore_places_leaves_by_like(tmp_path, monkeypatch):
    """Tensor leaves go where their ``like`` leaf lies; other leaves need a
    device, the card unless one is given (raises without a GPU)."""
    tckpt.save_pytree(tmp_path, 1, {"w": torch.arange(3, dtype=torch.int32), "s": 2})
    back = tckpt.restore_pytree(tmp_path, 1, {"w": torch.zeros(3, dtype=torch.int64),
                                              "s": 0})
    assert back["w"].dtype == torch.int64 and back["s"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore_pytree(tmp_path, 1, {"w": np.zeros(3, np.int32), "s": 0})
    back = tckpt.restore_pytree(tmp_path, 1, {"w": np.zeros(3, np.int32), "s": 0},
                                device="cpu")
    assert back["w"].device.type == "cpu" and back["w"].tolist() == [0, 1, 2]
    e = tckpt.leaf_manifest(tmp_path, 1)["['w']"]
    assert e["crc32"] == zlib.crc32(np.arange(3, dtype=np.int32).tobytes())
