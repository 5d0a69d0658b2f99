"""The port's packed-document training, "dots" remat and LM sharding specs
against the JAX package, on the CPU.

* ``data.pipeline``: ``pack_documents`` and ``TokenPipeline`` bitwise the
  reference's (tokens, labels, segments, epoch order, shards, resume).
* Packed isolation at reduced granite-3-2b (2 layers, d_model 256, f32):
  two documents packed in one row give the logits of each in a row of its
  own, within the reference test's rtol 2e-2, atol 2e-3 (the second
  document sits 16 positions later in the packed row; rope is relative, so
  only rounding differs), and a mask that ignores the segments does not.
* ``remat_policy="dots"`` with packed rows: loss and every gradient within
  the tolerances of ``tests/test_torch_lm_train.py`` (loss rtol 1e-5,
  gradients rtol 1e-4, atol 1e-5 x the leaf's largest) of the reference's
  "dots".
* ``sharding``: every spec leaf equal to the reference's, both read as
  tuples with trailing Nones stripped (the reference keeps some), on the
  reference test's meshes and a small one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro.models as JM
import repro.optim as JO
import repro.sharding as JSH
import repro_torch.configs as tconfigs
import repro_torch.optim as TO
import repro_torch.sharding as TSH
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.data.pipeline import pack_documents as j_pack
from repro.models import transformer as JT
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import TokenPipeline, pack_documents
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.cache import cache_structure
from repro_torch.optim.optimizers import tree_leaves


# ----------------------------------------------------------------- pipeline
def _docs(seed: int, n_docs: int, seq_len: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1000, size=rng.integers(1, 3 * seq_len)) for _ in range(n_docs)]


@pytest.mark.parametrize("seed,n_docs,seq_len", [
    (0, 1, 16), (1, 7, 16), (2, 30, 32), (3, 12, 129), (4, 0, 8),
])
def test_pack_documents_is_the_reference_s(seed, n_docs, seq_len):
    docs = _docs(seed, n_docs, seq_len)
    got, want = pack_documents(docs, seq_len), j_pack(docs, seq_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    tokens, segments = got
    np.testing.assert_array_equal(
        tokens[segments > 0],
        np.concatenate([d.astype(np.int32) for d in docs]) if docs else np.zeros(0, np.int32))
    for row in segments:  # ids restart at 1 each row and never fall
        nz = row[row > 0]
        assert nz[0] == 1 and (np.diff(nz) >= 0).all()


@pytest.mark.parametrize("seed,batch,num_shards,packed", [
    (0, 4, 1, False), (3, 4, 1, True), (9, 2, 4, True), (5, 3, 2, False),
])
def test_token_pipeline_is_the_reference_s(seed, batch, num_shards, packed):
    """Every batch of two and a half epochs on every shard, and a resumed
    stream, bitwise the reference's."""
    if packed:
        tokens, segments = pack_documents(_docs(seed, 60, 17), 17)
    else:
        tokens = np.random.default_rng(seed).integers(0, 100, (64, 9)).astype(np.int32)
        segments = None
    for shard in range(num_shards):
        kw = dict(batch_size=batch, seed=seed, shard_id=shard, num_shards=num_shards,
                  segments=segments)
        got, want = TokenPipeline(tokens, **kw), JPipeline(tokens, **kw)
        assert got.steps_per_epoch == want.steps_per_epoch
        steps = 5 * got.steps_per_epoch // 2
        for step in range(steps):
            g, w = got.batch_at(step), want.batch_at(step)
            assert set(g) == set(w) == ({"tokens", "labels", "segments"} if packed
                                        else {"tokens", "labels"})
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        resumed, stream = got.iterate(steps // 2), want.iterate(0)
        first = [next(stream) for _ in range(steps)]
        for i in range(steps // 2, steps):
            np.testing.assert_array_equal(next(resumed)["tokens"], first[i]["tokens"])


def test_token_pipeline_refuses_what_the_reference_refuses():
    tokens = np.zeros((8, 9), np.int32)
    for cls in (TokenPipeline, JPipeline):
        with pytest.raises(ValueError, match="shard smaller"):
            cls(tokens, batch_size=4, num_shards=4)
        with pytest.raises(ValueError, match=r"\(N, S\+1\)"):
            cls(tokens[0], batch_size=1)


# ------------------------------------------------------------------- models
def _granite(**changes):
    return dataclasses.replace(tconfigs.get("granite-3-2b").reduced(), **changes)


def test_packed_segments_isolate_documents():
    """Two documents packed in one row give the logits of each in a row of
    its own; with the segment mask left out (every token in segment 1) the
    second one's do not."""
    cfg = _granite(attn_chunk=8)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    d1, d2 = (torch.from_numpy(rng.integers(0, cfg.vocab_size, 16)) for _ in range(2))
    packed = torch.cat([d1, d2])[None]
    segs = torch.cat([torch.ones(16), torch.full((16,), 2)])[None].int()

    def logits(tokens, segments=None):
        x = params["embed"][tokens]
        h, _ = TT.backbone_train(params, cfg, x, segments)
        return TT._logits(params, cfg, h).detach().numpy()

    lg_packed = logits(packed, segs)
    lg_sep = logits(torch.stack([d1, d2]))
    np.testing.assert_allclose(lg_packed[0, :16], lg_sep[0], rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(lg_packed[0, 16:], lg_sep[1], rtol=2e-2, atol=2e-3)
    leaked = logits(packed, torch.ones_like(segs))
    assert not np.allclose(leaked[0, 16:], lg_sep[1], rtol=2e-2, atol=2e-3)


def test_a_pad_query_attends_to_nothing_and_gets_no_gradient():
    """A segment-0 query has no valid key: its output and the gradient
    through it are 0, never NaN, while the row's other queries learn."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 6, 2, 8, generator=g, requires_grad=True) for _ in range(3))
    seg = torch.tensor([[1, 1, 2, 2, 0, 0]])
    pos = torch.arange(6)
    out = TL.chunked_attention(q, k, v, pos, pos, 6, True, 4, segments=seg)
    assert torch.equal(out[:, 4:], torch.zeros_like(out[:, 4:]))
    dq, dk, dv = torch.autograd.grad(out.square().sum() + out.sum(), (q, k, v))
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
    assert torch.equal(dq[:, 4:], torch.zeros_like(dq[:, 4:]))
    assert float(dq[:, :4].abs().max()) > 0


def _paths(tree, prefix=()):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (key,))
        else:
            yield prefix + (key,), v


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_dots_remat_on_packed_rows_matches_the_reference(attn_impl):
    """forward_train under "dots" on packed rows with pad tails, loss and
    every gradient against the reference's "dots" (flash falls back to the
    chunked path in both packages: the rows are packed)."""
    changes = dict(attn_impl=attn_impl, remat_policy="dots", n_kv_heads=2, attn_chunk=16)
    cfg_j = dataclasses.replace(jconfigs.get("granite-3-2b").reduced(), **changes)
    cfg_t = _granite(**changes)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    rng = np.random.default_rng(4)
    tokens, segments = pack_documents(
        [rng.integers(1, cfg_t.vocab_size, n) for n in (30, 50, 9, 40, 20)], 41)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:], "segments": segments[:, :-1]}
    assert batch["tokens"].shape[0] == 4 and (batch["segments"] == 0).any()
    (lj, _), gj = jax.jit(jax.value_and_grad(JT.forward_train, has_aux=True),
                          static_argnums=1)(params_j, cfg_j,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.requires_grad_() for _, p in _paths(params_t)]
    lt, _ = TT.forward_train(params_t, cfg_t,
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for (path, _), g in zip(_paths(params_t), gt):
        w = np.asarray(_get(gj, path))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=".".join(path))


# ----------------------------------------------------------------- sharding
MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "small": {"data": 2, "model": 4},
}
ARCHS = ["h2o-danube-1.8b", "minitron-4b", "granite-3-2b", "codeqwen1.5-7b", "zamba2-1.2b"]
# (batch, seq_len): decode_32k, long_500k, and a ragged one.
CACHE_SHAPES = [(128, 32_768), (1, 524_288), (3, 1000)]


@dataclasses.dataclass
class FakeMesh:
    shape: dict


def _norm(spec) -> tuple:
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _same_specs(got, want, where="") -> None:
    """``got`` (the port's) leaf for leaf equal to ``want`` (the reference's)."""
    if isinstance(want, JP):
        assert isinstance(got, TSH.PartitionSpec), where
        assert tuple(got) == _norm(want), f"{where}: {got} vs {want}"
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same_specs(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__, where
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_specs(g, w, f"{where}[{i}]")
    else:
        raise AssertionError(f"{where}: unexpected leaf {want!r}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_and_cache_specs_are_the_reference_s(arch, mesh):
    tmesh, jmesh = make_dry_mesh(MESHES[mesh]), FakeMesh(MESHES[mesh])
    cfg_t, cfg_j = tconfigs.get(arch), jconfigs.get(arch)
    for rules_t, rules_j in ((None, None), (TSH.serving_rules(), JSH.serving_rules())):
        _same_specs(TSH.param_specs(cfg_t, tmesh, rules_t),
                    JSH.param_specs(cfg_j, jmesh, rules_j), arch)
    for b, s in CACHE_SHAPES:
        got, want = TSH.cache_specs(cfg_t, tmesh, b, s), JSH.cache_specs(cfg_j, jmesh, b, s)
        _same_specs(got, want, f"{arch} cache {b}x{s}")
        # and congruent with the cache's blueprint, every dim divisible
        struct = cache_structure(cfg_t, b, s)
        for path, leaf in _paths(struct):
            for dim, part in zip(leaf.shape, _get(got, path)):
                for a in (() if part is None else (part,) if isinstance(part, str) else part):
                    assert dim % MESHES[mesh][a] == 0, (path, leaf.shape, part)


def test_rule_tables_and_batch_axes_are_the_reference_s():
    assert TSH.DEFAULT_RULES == JSH.DEFAULT_RULES
    assert TSH.serving_rules() == JSH.serving_rules()
    for shape in MESHES.values():
        assert TSH.batch_axes(make_dry_mesh(shape)) == JSH.batch_axes(FakeMesh(shape))
    spec = TSH.spec_for((4096, 8192), ("embed", "ff"), make_dry_mesh(MESHES["multi"]))
    assert spec == TSH.PartitionSpec(("data", "pod"), "model")
    with pytest.raises(ValueError, match="vs axes"):
        TSH.spec_for((4, 4), ("embed",), make_dry_mesh(MESHES["small"]))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_data_specs_and_divisible_batch_axes_are_the_reference_s(mesh):
    tmesh, jmesh = make_dry_mesh(MESHES[mesh]), FakeMesh(MESHES[mesh])
    for b in (1, 2, 3, 16, 32, 256):
        assert TSH.divisible_batch_axes(tmesh, b) == JSH.divisible_batch_axes(jmesh, b)
        for arch in ARCHS:
            _same_specs(TSH.data_specs(tconfigs.get(arch), tmesh, b),
                        JSH.data_specs(jconfigs.get(arch), jmesh, b), f"{arch} {b}")


@pytest.mark.parametrize("opt", ["adamw", "adamw-clip-decay", "sgd", "sgd-momentum",
                                 "delayed-adamw"])
def test_optimizer_state_specs_are_the_reference_s(opt):
    def make(O):
        inner = {"adamw": lambda: O.adamw(1e-3),
                 "adamw-clip-decay": lambda: O.adamw(1e-3, weight_decay=0.1,
                                                     max_grad_norm=1.0),
                 "sgd": lambda: O.sgd(0.1),
                 "sgd-momentum": lambda: O.sgd(0.1, momentum=0.9),
                 "delayed-adamw": lambda: O.delayed_gradient(
                     O.adamw(1e-3, max_grad_norm=1.0), 3)}[opt]
        return inner()

    cfg_t, cfg_j = _granite(), jconfigs.get("granite-3-2b").reduced()
    tmesh, jmesh = make_dry_mesh(MESHES["small"]), FakeMesh(MESHES["small"])
    params_t = TT.init_params(cfg_t, device="meta")
    state_t = make(TO).init(params_t)
    state_j = jax.eval_shape(make(JO).init, JT.abstract_params(cfg_j))
    pspecs_t, pspecs_j = TSH.param_specs(cfg_t, tmesh), JSH.param_specs(cfg_j, jmesh)
    _same_specs(TSH.optimizer_state_specs(state_t, pspecs_t),
                JSH.optimizer_state_specs(state_j, pspecs_j), opt)
    with pytest.raises(TypeError, match="unknown optimizer state"):
        TSH.optimizer_state_specs({"w": 0}, pspecs_t)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small", "xlstm-1.3b"])
def test_specs_of_unported_families_raise(arch):
    """Every family is ported now: the VLM, audio and xLSTM families' specs
    are the reference's (every mesh: tests/test_torch_media.py and
    tests/test_torch_shapes.py); a family the zoo does not have raises
    ``ValueError``, and the xLSTM family refuses packed rows, as the hybrid
    one does (the reference's rule)."""
    cfg, mesh = tconfigs.get(arch), make_dry_mesh(MESHES["small"])
    jcfg, jmesh = jconfigs.get(arch), FakeMesh(MESHES["small"])
    _same_specs(TSH.param_specs(cfg, mesh), JSH.param_specs(jcfg, jmesh), arch)
    _same_specs(TSH.data_specs(cfg, mesh, 4), JSH.data_specs(jcfg, jmesh, 4), arch)
    _same_specs(TSH.cache_specs(cfg, mesh, 4, 128), JSH.cache_specs(jcfg, jmesh, 4, 128),
                arch)
    unknown = dataclasses.replace(cfg, family="rwkv")
    for fn in (lambda: TSH.param_specs(unknown, mesh),
               lambda: TSH.data_specs(unknown, mesh, 4),
               lambda: TSH.cache_specs(unknown, mesh, 4, 128)):
        with pytest.raises(ValueError, match="unknown model family"):
            fn()
    if cfg.family == "ssm":
        small = cfg.reduced()
        params = TT.init_params(small, torch.Generator().manual_seed(0), device="cpu")
        toks = torch.zeros((1, 16), dtype=torch.int32)
        with pytest.raises(ValueError, match="per-segment state resets"):
            TT.forward_train(params, small, {"tokens": toks, "labels": toks, "segments": toks})


def test_the_specs_cover_every_parameter_and_optimizer_leaf():
    """``param_specs`` has one spec a parameter, and the delayed ring's spec
    shards as its parameter does behind one unsharded delay axis."""
    cfg, mesh = _granite(), make_dry_mesh(MESHES["small"])
    params = TT.init_params(cfg, device="meta")
    specs = TSH.param_specs(cfg, mesh)
    assert [p for p, _ in _paths(specs)] == [p for p, _ in _paths(params)]
    state = TO.delayed_gradient(TO.sgd(0.1), 2).init(params)
    ring = TSH.optimizer_state_specs(state, specs).ring
    for (path, s), leaf in zip(_paths(ring), tree_leaves(state.ring)):
        assert leaf.dim() == len(_get(params, path).shape) + 1
        assert tuple(s) == tuple(TSH.PartitionSpec(None, *_get(specs, path)))
