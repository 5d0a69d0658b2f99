"""The port's xLSTM family (mLSTM and sLSTM layers) against the JAX
package, on the CPU.

Reduced xlstm-1.3b (4 layers: 2 groups of one mLSTM and one sLSTM layer,
d_model 256, 4 heads of 64, chunk 16, vocab 512, f32). The JAX package's
parameters are carried across by ``convert.lm_params_from_numpy``; both
packages get the same numpy inputs.

Tolerances: mLSTM and sLSTM pieces, logits and cache leaves rtol/atol 1e-4
(f32 sums in another order); loss rtol 1e-5; gradients rtol 1e-4, atol
1e-5 x the leaf's largest gradient (as tests/test_torch_lm_train.py); the
bf16 layers by relative L2 2e-2 (the packages round bf16 products in other
places; a wrong cast costs more); decode against the teacher-forced oracle
at ``ssm_chunk=1`` rtol 2e-2, atol 2e-3 (as tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import cache as JC
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.models import cache as TC
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.serving import Request, ServingEngine

ARCH = "xlstm-1.3b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these models are small, and the suite runs files
    side by side, where each file's thread pool would contend for the
    same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**changes):
    return (dataclasses.replace(jconfigs.get(ARCH).reduced(), **changes),
            dataclasses.replace(tconfigs.get(ARCH).reduced(), **changes))


def _pair(seed=0, **changes):
    """Both packages' parameters from one seeded numpy draw: weights normal
    / sqrt(fan_in), norm scales 1 + N(0, 0.1^2) and the gate biases N(0,
    0.1^2) (so none is the identity), in the model's dtype (bf16 through
    ``ml_dtypes``)."""
    cfg_j, cfg_t = _cfgs(**changes)
    rng = np.random.default_rng(seed)

    def make(path, e):
        noise = rng.standard_normal(e.shape)
        if e.init in ("ones", "zeros"):
            return (e.init == "ones") + 0.1 * noise
        return noise / np.sqrt(e.shape[-2] if len(e.shape) >= 2 else e.shape[-1])

    arrays = TT.map_schema(make, TT.param_schema(cfg_t))
    params_j = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), arrays,
                            JT.abstract_params(cfg_j))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def model():
    return _pair()


@pytest.fixture(scope="module")
def model_bf16():
    return _pair(dtype="bfloat16")


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-4, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().float().numpy() - want) / np.linalg.norm(want))


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


def _layers(params_j, params_t, kind):
    """The first group's first ``kind`` ("mlstm" or "slstm") layer in both
    packages."""
    if kind == "mlstm":
        return (jax.tree.map(lambda a: a[0, 0], params_j["groups"]["mlstm"]),
                TT.layer(TT.layer(params_t["groups"]["mlstm"], 0), 0))
    return (jax.tree.map(lambda a: a[0], params_j["groups"]["slstm"]),
            TT.layer(params_t["groups"]["slstm"], 0))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ------------------------------------------------------------ the layers
@pytest.mark.parametrize("s", [16, 48], ids=["1-chunk", "3-chunks"])
@pytest.mark.parametrize("return_state", [False, True], ids=["out", "out+state"])
def test_mlstm_chunk_scan(s, return_state):
    """The chunk scan on its own: q, k, v (B, S, H, p), the log input gate
    N(0, 1), the log forget gate log sigmoid(N(1, 1)); the state (C, n,
    m) carried over two chunks boundaries in the 48-token case."""
    b, h, p = 2, 4, 64
    q, k, v = (_x((b, s, h, p), i) for i in range(3))
    li = _x((b, s, h), 3)
    lf = np.log(1 / (1 + np.exp(-(_x((b, s, h), 4) + 1)))).astype(np.float32)
    want = JX._mlstm_chunk_scan(*map(jnp.asarray, (q, k, v, li, lf)), 16,
                                return_state=return_state)
    got = TX._mlstm_chunk_scan(*map(torch.from_numpy, (q, k, v, li, lf)), 16,
                               return_state=return_state)
    if return_state:
        want, got = (want[0], *want[1]), (got[0], *got[1])
        assert got[-1].dtype == torch.float32
    else:
        want, got = (want,), (got,)
    for name, g, w in zip(("y", "C", "n", "m"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, msg=name)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("return_state", [False, True], ids=["out", "out+state"])
def test_layer_train(model, kind, return_state):
    """A layer over 48 tokens (three chunks of 16 for the mLSTM), with its
    norm's input scale."""
    cfg_j, params_j, cfg_t, params_t = model
    pj, pt = _layers(params_j, params_t, kind)
    x = _x((2, 48, cfg_t.d_model), 7)
    fj, ft = (JX.mlstm_train, TX.mlstm_train) if kind == "mlstm" else (JX.slstm_train,
                                                                         TX.slstm_train)
    want = fj(pj, jnp.asarray(x), cfg_j, return_state=return_state)
    got = ft(pt, torch.from_numpy(x), cfg_t, return_state=return_state)
    if return_state:
        want, got = (want[0], *want[1]), (got[0], *got[1])
    else:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), i
        _close(g, w, msg=f"{kind} output {i}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_decode(model, kind):
    """Six tokens one at a time from a 16-token prefilled state, each step's
    state fed back, against the reference's step."""
    cfg_j, params_j, cfg_t, params_t = model
    pj, pt = _layers(params_j, params_t, kind)
    x = _x((2, 22, cfg_t.d_model), 8)
    train_j, train_t = (JX.mlstm_train, TX.mlstm_train) if kind == "mlstm" else (
        JX.slstm_train, TX.slstm_train)
    decode_j = jax.jit(JX.mlstm_decode if kind == "mlstm" else JX.slstm_decode,
                       static_argnums=5 if kind == "mlstm" else 6)
    decode_t = TX.mlstm_decode if kind == "mlstm" else TX.slstm_decode
    _, sj = train_j(pj, jnp.asarray(x[:, :16]), cfg_j, return_state=True)
    _, st = train_t(pt, torch.from_numpy(x[:, :16]), cfg_t, return_state=True)
    for t in range(16, 22):
        yj, *sj = decode_j(pj, jnp.asarray(x[:, t:t + 1]), *sj, cfg_j)
        yt, *st = decode_t(pt, torch.from_numpy(x[:, t:t + 1]), *st, cfg_t)
        _close(yt, yj, msg=f"y at token {t}")
        for i, (g, w) in enumerate(zip(st, sj)):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), i
            _close(g, w, msg=f"state {i} at token {t}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_train_bf16(model_bf16, kind):
    """The same layers in bf16 in both packages: the carries C, n, c, h
    stay bf16, the stabilisers m f32, and the outputs agree by relative
    L2."""
    cfg_j, params_j, cfg_t, params_t = model_bf16
    pj, pt = _layers(params_j, params_t, kind)
    x = _x((2, 32, cfg_t.d_model), 9)
    fj, ft = (JX.mlstm_train, TX.mlstm_train) if kind == "mlstm" else (JX.slstm_train,
                                                                         TX.slstm_train)
    want, sj = fj(pj, jnp.asarray(x, jnp.bfloat16), cfg_j, return_state=True)
    got, st = ft(pt, torch.from_numpy(x).bfloat16(), cfg_t, return_state=True)
    assert got.dtype == torch.bfloat16
    assert [str(t.dtype).split(".")[-1] for t in st] == [str(t.dtype) for t in sj]
    assert st[2].dtype == torch.float32 and st[0].dtype == torch.bfloat16
    for i, (g, w) in enumerate(zip((got, *st), (want, *sj))):
        assert _rel_l2(g, w) <= 2e-2, (i, _rel_l2(g, w))


def test_ragged_chunks_are_refused(model):
    """24 tokens do not divide into chunks of 16: the layer, the model and
    the engine refuse them (the reference asserts), and the engine does so
    at submit."""
    _, _, cfg, params = model
    pt = TT.layer(TT.layer(params["groups"]["mlstm"], 0), 0)
    with pytest.raises(ValueError, match="ssm_chunk 16"):
        TX.mlstm_train(pt, torch.zeros((1, 24, cfg.d_model)), cfg)
    with pytest.raises(ValueError, match="chunks of 16"):
        TT.prefill(params, cfg, {"tokens": torch.zeros((1, 24), dtype=torch.int32)})
    engine = ServingEngine(cfg, params, slots=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="request 3: a sequence of 24 tokens"):
        engine.submit(Request(uid=3, prompt=np.zeros(24, np.int32), max_new_tokens=4))
    engine.submit(Request(uid=4, prompt=np.zeros(12, np.int32), max_new_tokens=4))  # one chunk


# ------------------------------------------------------ schema, init, cache
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_schema_is_the_reference(dtype):
    cfg_j, cfg_t = _cfgs(dtype=dtype)
    want, got = {}, {}
    JT._map_schema(lambda p, e: want.setdefault(p, e), JT.param_schema(cfg_j))
    TT.map_schema(lambda p, e: got.setdefault(p, e), TT.param_schema(cfg_t))
    assert list(got) == list(want)  # the same names in the same (draw) order
    abstract_j, abstract_t = JT.abstract_params(cfg_j), TT.abstract_params(cfg_t)
    for path, e in want.items():
        assert tuple(got[path]) == (e.shape, e.axes, e.init), path
        leaf = _get(abstract_t, path)
        assert leaf.device.type == "meta" and tuple(leaf.shape) == e.shape, path
        assert str(leaf.dtype).split(".")[-1] == str(_get(abstract_j, path).dtype), path
    assert TT.xlstm_layout(cfg_t) == (2, 1)
    assert got[("groups", "mlstm", "wq")].shape == (2, 1, cfg_t.d_model, cfg_t.d_model)
    assert got[("groups", "slstm", "r_gates")].shape == (2, cfg_t.n_heads, 4, cfg_t.head_dim,
                                                         cfg_t.head_dim)


def test_full_width_layout_and_abstract_params():
    """xlstm-1.3b whole: 6 groups of 7 mLSTM layers and one sLSTM layer;
    the meta parameters allocate nothing and count ``ModelConfig.param_count``
    (which leaves out the norms and biases) plus the norms and biases."""
    cfg = tconfigs.get(ARCH)
    assert TT.xlstm_layout(cfg) == (6, 7)
    params = TT.abstract_params(cfg)
    n = sum(t.numel() for _, t in _paths(params))
    small = []
    TT.map_schema(lambda p, e: small.append(int(np.prod(e.shape))) if e.init != "normal"
                  else None, TT.param_schema(cfg))
    assert sum(small) == 49 * 2048 + 42 * 8 + 6 * 4 * 2048  # ln, final_norm, b_if, b_gates
    assert n - sum(small) == cfg.param_count() == jconfigs.get(ARCH).param_count()
    assert n == 1_239_206_224
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for _, t in _paths(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq_len", [48, 2048])
def test_init_cache_and_cache_structure_are_the_reference(dtype, seq_len):
    cfg_j, cfg_t = _cfgs(dtype=dtype)
    want = JC.init_cache(cfg_j, 3, seq_len)
    got = TC.init_cache(cfg_t, 3, seq_len, device="cpu")
    struct_j, struct_t = JC.cache_structure(cfg_j, 3, seq_len), TC.cache_structure(
        cfg_t, 3, seq_len)
    abstract_t = TC.abstract_cache(cfg_t, 3, seq_len)
    assert set(got) == set(want) == set(struct_t) == {"pos", "mlstm", "slstm"}
    for path, w in _paths(want):
        g, sj, st = _get(got, path), _get(struct_j, path), _get(struct_t, path)
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32),
                                      err_msg=str(path))
        assert st.device.type == "meta" and (tuple(st.shape), st.dtype) == (
            tuple(g.shape), g.dtype) and tuple(sj.shape) == w.shape, path
        assert tuple(_get(abstract_t, path).shape) == tuple(st.shape), path


@pytest.mark.parametrize("pair", ["model", "model_bf16"])
def test_lm_params_from_numpy_carries_every_leaf(pair, request):
    """The doubly stacked ``groups.mlstm`` and the (g, H, 4, hd, hd)
    ``r_gates`` leaf come across bit for bit, in the model's dtype, and a
    ``LanguageModel`` takes them."""
    _, ref, cfg_t, got = request.getfixturevalue(pair)
    dtype = cfg_t.dtype
    assert sorted(p for p, _ in _paths(got)) == sorted(p for p, _ in _paths(ref))
    for path, t in _paths(got):
        w = np.asarray(_get(ref, path))
        assert tuple(t.shape) == w.shape and t.dtype == getattr(torch, dtype), path
        np.testing.assert_array_equal(t.float().numpy(), w.astype(np.float32),
                                      err_msg=".".join(path))
    model = TT.LanguageModel(cfg_t, got)
    assert model.state_dict()["groups.slstm.r_gates"].shape == (2, 4, 4, 64, 64)
    assert model.state_dict()["groups.mlstm.w_if"].shape == (2, 1, 256, 8)


# --------------------------------------------------------------- training
def _batch(cfg, b, s, seed):
    toks = _tokens(cfg, b, s + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _leaves(params0, cfg):
    leaves = [p.detach().clone().requires_grad_() for _, p in _paths(params0)]
    it = iter(leaves)
    return leaves, TT.map_schema(lambda path, e: next(it), TT.param_schema(cfg))


def test_forward_train_loss_and_gradients(model):
    cfg_j, params_j, cfg_t, params_t = model
    batch = _batch(cfg_t, 2, 32, 2)
    (lj, mj), gj = jax.jit(jax.value_and_grad(JT.forward_train, has_aux=True),
                           static_argnums=1)(params_j, cfg_j,
                                             {k: jnp.asarray(v) for k, v in batch.items()})
    leaves, params = _leaves(params_t, cfg_t)
    lt, mt = TT.forward_train(params, cfg_t,
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0
    for (path, _), g in zip(_paths(params_t), gt):
        w = np.asarray(_get(gj, path))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=".".join(path))


def test_group_remat_gives_the_same_gradients(model):
    """Checkpointed groups (one a group, no policy) against no remat, bit
    for bit; ``remat_policy`` is not read on this branch."""
    _, _, cfg, params0 = model
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 32, 3).items()}
    grads = []
    for changes in ({"remat": True}, {"remat": False},
                    {"remat": True, "remat_policy": "dots"}):
        leaves, params = _leaves(params0, cfg)
        loss, _ = TT.forward_train(params, dataclasses.replace(cfg, **changes), batch)
        grads.append(torch.autograd.grad(loss, leaves))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert torch.equal(a, b)


def test_segments_raise_value_error(model):
    _, _, cfg, params = model
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 16, 4).items()}
    with pytest.raises(ValueError, match="recurrent families"):
        TT.forward_train(params, cfg, {**batch, "segments": batch["tokens"]})


def test_train_cli_runs_xlstm_on_the_cpu(capsys):
    losses = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "32", "--log-every", "1", "--accum", "2"])
    out = capsys.readouterr().out
    assert "family=ssm" in out and "final loss" in out
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_synthetic_batches_take_the_xlstm_family():
    _, cfg = _cfgs()
    b = next(ttrain.synthetic_batches(cfg, 2, 16, 1, device="cpu"))
    assert b["tokens"].shape == b["labels"].shape == (2, 16) and set(b) == {"tokens", "labels"}


# ---------------------------------------------------------------- serving
def _check_cache(got: dict, want: dict):
    assert int(got["pos"]) == int(want["pos"])
    for path, w in _paths({k: v for k, v in want.items() if k != "pos"}):
        g = _get(got, path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        _close(g, w, msg=".".join(path))


def test_prefill_and_decode(model):
    """Prefill (32 tokens: two chunks) then 8 decode steps, each the
    reference's; every cache leaf compared after prefill and after
    decode."""
    cfg_j, params_j, cfg_t, params_t = model
    toks = _tokens(cfg_t, 2, 32, 10)
    prefill_j = jax.jit(lambda p, t: JT.prefill(p, cfg_j, {"tokens": t}, max_len=48))
    decode_j = jax.jit(lambda p, t, c: JT.decode_step(p, cfg_j, t, c))
    lj, cj = prefill_j(params_j, jnp.asarray(toks))
    lt, ct = TT.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks)}, max_len=48)
    assert lt.shape == (2, cfg_t.padded_vocab)
    _close(lt, lj)
    _check_cache(ct, cj)
    leaves = [t for _, t in _paths(ct)]
    nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for i in range(8):
        lj, cj = decode_j(params_j, jnp.asarray(nxt[:, None]), cj)
        lt, ct = TT.decode_step(params_t, cfg_t, torch.from_numpy(nxt[:, None]), ct)
        _close(lt, lj, msg=f"decode step {i}")
        nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    _check_cache(ct, cj)
    # written in place: the same tensors as after prefill
    assert all(a is b for a, b in zip(leaves[1:], [t for _, t in _paths(ct)][1:]))


def test_decode_follows_the_teacher_forced_oracle(model):
    """8 decode steps after a 16-token prompt, each against the port's own
    full-sequence forward at ``ssm_chunk=1`` (the pure recurrence)."""
    _, _, cfg, params = model
    ocfg = dataclasses.replace(cfg, ssm_chunk=1)
    s, extra = 16, 8
    toks = torch.from_numpy(_tokens(cfg, 1, s + extra, 11))
    _, cache = TT.prefill(params, cfg, {"tokens": toks[:, :s]}, max_len=s + extra)
    with torch.no_grad():
        h, _ = TT.backbone_train(params, ocfg, params["embed"][toks.long()])
        oracle = TT._logits(params, ocfg, h)
    for i in range(extra):
        lg, cache = TT.decode_step(params, cfg, toks[:, s + i:s + i + 1], cache)
        np.testing.assert_allclose(lg.numpy(), oracle[:, s + i].numpy(), rtol=2e-2, atol=2e-3,
                                   err_msg=f"divergence at decode step {i}")


def test_serving_engine_same_tokens_as_the_reference(model):
    cfg_j, params_j, cfg_t, params_t = model
    sizes = [(16, 6), (16, 4), (32, 6), (16, 6), (16, 2)]

    def reqs(cls, cfg):
        return [cls(uid=i, prompt=_tokens(cfg, 1, p, 20 + i)[0], max_new_tokens=n)
                for i, (p, n) in enumerate(sizes)]

    got = ServingEngine(cfg_t, params_t, slots=4, max_len=64, device="cpu").run(
        reqs(Request, cfg_t))
    want = JServingEngine(cfg_j, params_j, slots=4, max_len=64).run(reqs(JRequest, cfg_j))
    assert [c.uid for c in got] == [c.uid for c in want] == list(range(len(sizes)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
