"""``launch.shapes`` of the port against the JAX package's, and the xLSTM
family's sharding specs against the reference's: nothing is allocated.

For every config of the registry and every assigned shape, the skip
reason is the reference's, and the abstract batch, decode tokens and decode
cache (``meta`` tensors in the port, ``ShapeDtypeStruct`` leaves in the
reference) have its shapes and dtypes, leaf for leaf: the 32k and
524k-token caches of every config included. Exact comparisons throughout.
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro.sharding as JSH
import repro_torch.configs as tconfigs
import repro_torch.sharding as TSH
from repro.launch import shapes as JS
from repro_torch.launch import shapes as TS
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models.cache import cache_structure

ARCHS = list(jconfigs.ALIASES)
MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "small": {"data": 2, "model": 4},
    "heads_unshardable": {"data": 4, "model": 8},
}
# (batch, seq_len): decode_32k, long_500k, a ragged one.
CACHE_SHAPES = [(128, 32_768), (1, 524_288), (3, 1000)]


@dataclasses.dataclass
class FakeMesh:
    shape: dict


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _same_leaves(got: dict, want: dict, where: str) -> None:
    """Every ``meta`` tensor of ``got`` has the shape and dtype of the
    ``ShapeDtypeStruct`` at its path in ``want``, and no path is missing."""
    assert sorted(p for p, _ in _paths(got)) == sorted(p for p, _ in _paths(want)), where
    for path, w in _paths(want):
        g = _get(got, path)
        assert g.device.type == "meta", (where, path)
        assert tuple(g.shape) == tuple(w.shape), (where, path, g.shape, w.shape)
        assert jnp.dtype(str(g.dtype).split(".")[-1]) == w.dtype, (where, path, g.dtype)


def test_shape_table_is_the_reference_s():
    assert {k: dataclasses.astuple(v) for k, v in TS.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JS.SHAPES.items()}
    with pytest.raises(dataclasses.FrozenInstanceError):
        TS.SHAPES["train_4k"].seq_len = 1


@pytest.mark.parametrize("arch", ARCHS)
def test_skips_and_abstract_inputs_are_the_reference_s(arch):
    cfg_t, cfg_j = tconfigs.get(arch), jconfigs.get(arch)
    for name in JS.SHAPES:
        shape_t, shape_j = TS.SHAPES[name], JS.SHAPES[name]
        reason = TS.shape_skip_reason(cfg_t, shape_t)
        assert reason == JS.shape_skip_reason(cfg_j, shape_j), (arch, name)
        _same_leaves(TS.batch_inputs(cfg_t, shape_t), JS.batch_inputs(cfg_j, shape_j),
                     f"{arch} {name} batch")
        if shape_t.kind == "decode":
            (tok_t, cache_t), (tok_j, cache_j) = (TS.decode_inputs(cfg_t, shape_t),
                                                  JS.decode_inputs(cfg_j, shape_j))
            _same_leaves(tok_t, tok_j, f"{arch} {name} tokens")
            _same_leaves(cache_t, cache_j, f"{arch} {name} cache")


def test_the_skips_name_their_reason():
    long = TS.SHAPES["long_500k"]
    reasons = {a: TS.shape_skip_reason(tconfigs.get(a), long) for a in ARCHS}
    assert reasons["whisper-small"].startswith("enc-dec audio")
    assert [a for a, r in reasons.items() if r is not None] == ["whisper-small"]
    full = dataclasses.replace(tconfigs.get("granite-3-2b"), long_context_window=0)
    assert TS.shape_skip_reason(full, long) == "pure full attention cannot serve 524288 tokens"
    assert TS.shape_skip_reason(full, long) == JS.shape_skip_reason(
        dataclasses.replace(jconfigs.get("granite-3-2b"), long_context_window=0), long)
    assert all(TS.shape_skip_reason(tconfigs.get(a), TS.SHAPES["decode_32k"]) is None
               for a in ARCHS)


def test_xlstm_decode_cache_does_not_grow_with_the_context():
    """xlstm-1.3b's 524k-token cache holds the same bytes as its 32k one at
    the same batch: each layer's carry, nothing a position."""
    cfg = tconfigs.get("xlstm-1.3b")

    def nbytes(b, s):
        _, cache = TS.decode_inputs(cfg, TS.ShapeSpec("x", "decode", s, b))
        return sum(t.numel() * t.element_size() for _, t in _paths(cache))
    assert nbytes(1, 524_288) == nbytes(1, 32_768) == nbytes(1, 1)
    # 6 groups: 7 mLSTM layers of C (4 heads, 512 x 512) and n in bf16, m in
    # f32; one sLSTM layer of c, n, h in bf16 and m in f32; pos int32.
    want = 6 * (7 * 4 * (512 * 512 * 2 + 512 * 2 + 4) + 4 * 512 * (3 * 2 + 4)) + 4
    assert nbytes(1, 32_768) == want


def _norm(spec) -> tuple:
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _same_specs(got, want, where="") -> None:
    if isinstance(want, JP):
        # by name: a test that imports the package afresh makes a second class
        assert type(got).__name__ == "PartitionSpec", where
        assert tuple(got) == _norm(want), f"{where}: {got} vs {want}"
    else:
        assert set(got) == set(want), where
        for k in want:
            _same_specs(got[k], want[k], f"{where}.{k}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_xlstm_specs_are_the_reference_s(mesh):
    """The xLSTM family's parameter, batch and cache specs on a dry mesh,
    leaf for leaf the reference's; the cache's shard every dim they name
    evenly. At model 8 the 4 heads do not shard, so C, n and the sLSTM
    carries shard on head_dim."""
    tmesh, jmesh = make_dry_mesh(MESHES[mesh]), FakeMesh(MESHES[mesh])
    cfg_t, cfg_j = tconfigs.get("xlstm-1.3b"), jconfigs.get("xlstm-1.3b")
    _same_specs(TSH.param_specs(cfg_t, tmesh), JSH.param_specs(cfg_j, jmesh), "params")
    _same_specs(TSH.data_specs(cfg_t, tmesh, 32), JSH.data_specs(cfg_j, jmesh, 32), "data")
    for b, s in CACHE_SHAPES:
        got = TSH.cache_specs(cfg_t, tmesh, b, s)
        _same_specs(got, JSH.cache_specs(cfg_j, jmesh, b, s), f"cache {b}x{s}")
        for path, leaf in _paths(cache_structure(cfg_t, b, s)):
            for dim, part in zip(leaf.shape, _get(got, path)):
                for a in (() if part is None else (part,) if isinstance(part, str) else part):
                    assert dim % MESHES[mesh][a] == 0, (path, leaf.shape, part)
    specs = TSH.cache_specs(cfg_t, tmesh, 128, 32_768)
    if mesh == "heads_unshardable":
        assert _norm(specs["mlstm"]["c"]) == (None, None, "data", None, None, "model")
        assert _norm(specs["slstm"]["h"]) == (None, "data", None, "model")
    elif mesh == "small":
        assert _norm(specs["mlstm"]["c"]) == (None, None, "data", "model")
    assert all(t.device.type == "meta" for _, t in _paths(cache_structure(cfg_t, 128, 32_768)))
    assert torch.float32 == cache_structure(cfg_t, 1, 1)["mlstm"]["m"].dtype
