"""The port's hybrid LM family (zamba2: Mamba2 SSD layers and one shared
attention block) against the JAX package, on the CPU.

Reduced zamba2-1.2b (4 layers, shared block every 2, d_model 256, 4
heads on 4 kv heads, head_dim 64, d_ff 512, SSM state 16, 16 SSM heads of
32, chunk 16, vocab 512, f32), and a 5-layer variant with a tail Mamba2
layer (2 groups of 2, tail 1). The JAX package's ``init_params`` is carried
across by ``convert.lm_params_from_numpy``; both packages get the same
numpy inputs. The flash path runs the Pallas kernels in interpret mode on
the JAX side and the plain versions on the port's.

Tolerances: SSM pieces, logits and cache leaves rtol/atol 1e-4 (f32 sums
in another order); loss rtol 1e-5; gradients rtol 1e-4, atol 1e-5 x the
leaf's largest gradient (as tests/test_torch_lm_train.py); one bf16
``mamba2_train`` by relative L2 2e-2 (the packages round bf16 products in
other places; a wrong cast costs more); decode against the teacher-forced
oracle at ``ssm_chunk=1`` rtol 2e-2, atol 2e-3 (as tests/test_models.py);
after an AdamW step parameters within 5e-5 for 99.9% of each leaf.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as JM
import repro.optim as JO
import repro_torch.configs as tconfigs
import repro_torch.optim as TO
from repro import checkpoint as jckpt
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import cache as JC
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import checkpoint as tckpt
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.cache import init_cache
from repro_torch.serving import Request, ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "zamba2-1.2b"
LAYERS = {"4L": {}, "5L-tail": {"n_layers": 5}}


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
    / sqrt(fan_in), norm scales and ``d_skip`` 1 + N(0, 0.1^2), the conv
    bias N(0, 0.1^2) (so none is the identity), ``a_log`` and ``dt_bias``
    by the reference's formulas; in each entry's dtype (bf16 through
    ``ml_dtypes``)."""
    cfg_j, cfg_t = _cfgs(**changes)
    rng = np.random.default_rng(seed)

    def make(path, e):
        if e.init == "alog":
            return np.broadcast_to(np.log1p(np.arange(e.shape[-1]) % 15) + 0.5, e.shape)
        if e.init == "dtbias":
            return np.full(e.shape, -4.0)
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
def models():
    return {name: _pair(**changes) for name, changes in LAYERS.items()}


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-4, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


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


def _mamba_layer(params_j, params_t):
    """The first Mamba2 layer's parameters in both packages."""
    pj = jax.tree.map(lambda a: a[0, 0], params_j["groups"]["mamba"])
    pt = TT.layer(TT.layer(params_t["groups"]["mamba"], 0), 0)
    return pj, pt


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ------------------------------------------------------------ the SSM layer
def test_conv_train(models):
    cfg_j, params_j, cfg_t, params_t = models["4L"]
    pj, pt = _mamba_layer(params_j, params_t)
    conv_ch = cfg_t.d_inner + 2 * cfg_t.ssm_state
    # a random conv weight and bias (init gives zeros for the bias)
    w, bias = _x((4, conv_ch), 1), _x((conv_ch,), 2, 0.1)
    u = _x((2, 24, conv_ch), 3)
    want = JS._conv_train({**pj, "conv_w": jnp.asarray(w), "conv_b": jnp.asarray(bias)},
                          jnp.asarray(u))
    got = TS._conv_train({**pt, "conv_w": torch.from_numpy(w), "conv_b": torch.from_numpy(bias)},
                         torch.from_numpy(u))
    _close(got, want)


def test_gated_norm():
    y, z, scale = _x((2, 8, 512), 4), _x((2, 8, 512), 5), _x((512,), 6)
    _close(TS._gated_norm(*map(torch.from_numpy, (y, z, scale))),
           JS._gated_norm(*map(jnp.asarray, (y, z, scale))))


@pytest.mark.parametrize("return_state", [False, True], ids=["out", "out+state"])
def test_mamba2_train(models, return_state):
    """48 tokens: three chunks of 16, the state carried across two."""
    cfg_j, params_j, cfg_t, params_t = models["4L"]
    pj, pt = _mamba_layer(params_j, params_t)
    x = _x((2, 48, cfg_t.d_model), 7)
    want = JS.mamba2_train(pj, jnp.asarray(x), cfg_j, return_state=return_state)
    got = TS.mamba2_train(pt, torch.from_numpy(x), cfg_t, return_state=return_state)
    if not return_state:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for name, g, w in zip(("out", "ssm_state", "conv_state"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, msg=name)


def test_mamba2_decode(models):
    """Six tokens one at a time from a prefilled state, the states fed back."""
    cfg_j, params_j, cfg_t, params_t = models["4L"]
    pj, pt = _mamba_layer(params_j, params_t)
    x = _x((2, 22, cfg_t.d_model), 8)
    _, hj, cj = JS.mamba2_train(pj, jnp.asarray(x[:, :16]), cfg_j, return_state=True)
    _, ht, ct = TS.mamba2_train(pt, torch.from_numpy(x[:, :16]), cfg_t, return_state=True)
    decode_j = jax.jit(JS.mamba2_decode, static_argnums=4)
    for t in range(16, 22):
        yj, hj, cj = decode_j(pj, jnp.asarray(x[:, t:t + 1]), hj, cj, cfg_j)
        yt, ht, ct = TS.mamba2_decode(pt, torch.from_numpy(x[:, t:t + 1]), ht, ct, cfg_t)
        for name, g, w in (("y", yt, yj), ("ssm_state", ht, hj), ("conv_state", ct, cj)):
            _close(g, w, msg=f"{name} at token {t}")


def test_mamba2_train_bf16():
    """The same layer in bf16 in both packages: a_log and dt_bias stay f32,
    the rest is bf16, and the outputs agree by relative L2."""
    cfg_j, params_j, cfg_t, params_t = _pair(dtype="bfloat16")
    pj, pt = _mamba_layer(params_j, params_t)
    assert pt["in_proj"].dtype == torch.bfloat16
    assert pt["a_log"].dtype == pt["dt_bias"].dtype == torch.float32
    x = _x((2, 32, cfg_t.d_model), 9)
    want, hj, _ = JS.mamba2_train(pj, jnp.asarray(x, jnp.bfloat16), cfg_j, return_state=True)
    got, ht, _ = TS.mamba2_train(pt, torch.from_numpy(x).bfloat16(), cfg_t, return_state=True)
    assert got.dtype == ht.dtype == torch.bfloat16
    for g, w in ((got, want), (ht, hj)):
        w = np.asarray(w, np.float32)
        rel = np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w)
        assert rel <= 2e-2, rel


def test_mamba2_train_refuses_a_ragged_chunk(models):
    _, _, cfg_t, params_t = models["4L"]
    pt = TT.layer(TT.layer(params_t["groups"]["mamba"], 0), 0)
    with pytest.raises(ValueError, match="ssm_chunk"):
        TS.mamba2_train(pt, torch.zeros((1, 24, cfg_t.d_model)), cfg_t)


# ------------------------------------------------------ schema, init, cache
@pytest.mark.parametrize("layers", list(LAYERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_schema_is_the_reference(layers, dtype):
    cfg_j, cfg_t = _cfgs(dtype=dtype, **LAYERS[layers])
    want, got = {}, {}
    JT._map_schema(lambda p, e: want.setdefault(p, e), JT.param_schema(cfg_j))
    TT.map_schema(lambda p, e: got.setdefault(p, e), TT.param_schema(cfg_t))
    assert list(got) == list(want)  # the same names in the same (draw) order
    abstract = JT.abstract_params(cfg_j)
    for path, e in want.items():
        assert tuple(got[path]) == (e.shape, e.axes, e.init), path
        dt = TT.entry_dtype(cfg_t, got[path])
        assert str(dt).split(".")[-1] == str(_get(abstract, path).dtype), path
    assert ("tail", "in_proj") in got if layers == "5L-tail" else ("tail", "in_proj") not in got
    assert got[("groups", "mamba", "a_log")].shape == (2, 2, cfg_t.ssm_heads)
    assert got[("shared", "attn", "wq")].shape == (cfg_t.d_model, cfg_t.q_dim)


def test_init_params_keeps_a_log_and_dt_bias_f32():
    """A bf16 model: a_log and dt_bias f32 with the reference's values in
    init_params, lm_params_from_numpy and LanguageModel; the rest bf16."""
    cfg_j, cfg_t = _cfgs(dtype="bfloat16", n_layers=5)
    params = TT.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    ref = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    converted = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, ref), device="cpu")
    for tree in (params, converted):
        for path, t in _paths(tree):
            want = torch.float32 if path[-1] in ("a_log", "dt_bias") else torch.bfloat16
            assert t.dtype == want, path
        for part in ("groups", "tail"):
            leaves = tree[part]["mamba"] if part == "groups" else tree[part]
            for name in ("a_log", "dt_bias"):
                want = np.asarray(ref[part]["mamba"][name] if part == "groups"
                                  else ref[part][name])
                # the port's own log(1 + h % 15) may round an ulp otherwise
                rtol = 0 if tree is converted else 2e-7
                np.testing.assert_allclose(leaves[name].numpy(), want, rtol=rtol, atol=0)
    model = TT.LanguageModel(cfg_t, converted)
    assert model.state_dict()["groups.mamba.a_log"].dtype == torch.float32
    with pytest.raises(ValueError, match="a_log"):
        TT.LanguageModel(cfg_t, {**converted, "tail": {**converted["tail"],
                                                       "a_log": converted["tail"]["a_log"].bfloat16()}})


@pytest.mark.parametrize("layers,seq_len", [("4L", 48), ("5L-tail", 40)])
def test_init_cache_is_the_reference(layers, seq_len):
    cfg_j, cfg_t = _cfgs(**LAYERS[layers])
    want = JC.init_cache(cfg_j, 3, seq_len)
    got = init_cache(cfg_t, 3, seq_len, device="cpu")
    assert set(got) == set(want) == {"pos", "ssm", "conv", "shared"}
    pairs = [("pos", got["pos"], want["pos"]), ("ssm", got["ssm"], want["ssm"]),
             ("conv", got["conv"], want["conv"])]
    pairs += [(f"shared.{n}", got["shared"][n], want["shared"][n]) for n in ("k", "v", "slot_pos")]
    for name, g, w in pairs:
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_family_gate_admits_dense_and_hybrid():
    for arch in ("granite-3-2b", ARCH):
        TT.param_schema(tconfigs.get(arch).reduced())


def test_family_gate_admits_moe():
    """The MoE family is ported (tests/test_torch_moe.py): the schema, the
    cache and the engine take it."""
    cfg = tconfigs.get("phi3.5-moe-42b").reduced()
    assert "moe" in TT.param_schema(cfg)["layers"]
    assert set(init_cache(cfg, 1, 8, device="cpu")) == {"pos", "self"}
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ServingEngine(cfg, params, device="cpu")


@pytest.mark.parametrize("family,item", [("vlm", "VLM"), ("audio", "audio"), ("ssm", "xLSTM")])
def test_family_gate_names_each_roadmap_item(family, item):
    """Every registered family is admitted now (the VLM and audio ones:
    tests/test_torch_media.py; ``item``, xLSTM: tests/test_torch_xlstm.py):
    the schema, the cache and the engine take it, and the engine serves. A
    family the zoo does not have raises ``ValueError`` in each."""
    arch = next(a for a in jconfigs.ALIASES if tconfigs.get(a).family == family)
    cfg = tconfigs.get(arch).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    keys = {"pos", "mlstm", "slstm"} if family == "ssm" else {"pos", "self", "media_k",
                                                               "media_v"}
    assert set(init_cache(cfg, 1, 8, device="cpu")) == keys, item
    out = ServingEngine(cfg, params, slots=2, max_len=24, device="cpu").run(
        [Request(uid=0, prompt=np.arange(8, dtype=np.int32), max_new_tokens=3)])
    assert out[0].tokens.shape == (3,) and (out[0].tokens < cfg.vocab_size).all()
    unknown = dataclasses.replace(cfg, family="rwkv")
    for fn in (lambda: TT.param_schema(unknown),
               lambda: init_cache(unknown, 1, 8, device="cpu"),
               lambda: ServingEngine(unknown, params, device="cpu")):
        with pytest.raises(ValueError, match="unknown model family"):
            fn()


# --------------------------------------------------------------- training
def _batch(cfg, b, s, seed):
    toks = _tokens(cfg, b, s + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("layers,attn_impl", [("4L", "chunked"), ("5L-tail", "flash")])
def test_forward_train_loss_and_gradients(models, layers, attn_impl):
    cfg_j, params_j, cfg_t, params_t = models[layers]
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    batch = _batch(cfg_t, 2, 32, 2)
    (lj, mj), gj = jax.jit(jax.value_and_grad(JT.forward_train, has_aux=True),
                           static_argnums=1)(params_j, cfg_j,
                                             {k: jnp.asarray(v) for k, v in batch.items()})
    paths = list(_paths(params_t))
    leaves = [p.detach().clone().requires_grad_() for _, p in paths]
    it = iter(leaves)
    params = TT.map_schema(lambda path, e: next(it), TT.param_schema(cfg_t))
    lt, mt = TT.forward_train(params, cfg_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0
    for (path, _), g in zip(paths, gt):
        w = np.asarray(_get(gj, path))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=".".join(path))


def test_group_remat_gives_the_same_gradients(models):
    """Checkpointed groups and tail layers (the shared block's gradient
    summed over its calls) against no remat, bit for bit."""
    _, _, cfg, params0 = models["5L-tail"]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 32, 3).items()}
    grads = []
    for remat in (True, False):
        leaves = [p.detach().clone().requires_grad_() for _, p in _paths(params0)]
        it = iter(leaves)
        params = TT.map_schema(lambda path, e: next(it), TT.param_schema(cfg))
        loss, _ = TT.forward_train(params, dataclasses.replace(cfg, remat=remat), batch)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_segments_raise_value_error(models):
    _, _, cfg, params = models["4L"]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 16, 4).items()}
    with pytest.raises(ValueError, match="recurrent families"):
        TT.forward_train(params, cfg, {**batch, "segments": batch["tokens"]})
    # remat_policy is not read on the hybrid branch, as in the reference
    loss, _ = TT.forward_train(params, dataclasses.replace(cfg, remat_policy="dots"), batch)
    assert torch.isfinite(loss)


def test_train_step_matches_reference():
    """One AdamW step (the train CLI's recipe, accum 2) through both packages'
    ``make_train_step``, and the reference's optimizer state carried across
    keeps its dtypes."""
    cfg_j, params_j, cfg_t, params_t = _pair(n_layers=5)
    batch = _batch(cfg_t, 4, 32, 5)

    def recipe(O):
        return O.adamw(O.cosine_schedule(5e-3, 1, 3), weight_decay=0.01, max_grad_norm=1.0)

    jopt, topt = recipe(JO), recipe(TO)
    sj = jopt.init(params_j)
    st = opt_state_from_numpy(cfg_t, jax.tree.map(np.asarray, sj), params_t)
    pj, sj, mj = jax.jit(j_make_train_step(cfg_j, jopt, accum=2))(
        params_j, sj, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    pt, st, mt = make_train_step(cfg_t, topt, accum=2)(
        params_t, st, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
    for path, p in _paths(pt):
        diff = np.abs(p.detach().numpy() - np.asarray(_get(pj, path)))
        assert (diff > 5e-5).mean() <= 1e-3, ".".join(path)
        assert diff.max() <= 2 * 5e-3, ".".join(path)


def test_bf16_train_step_keeps_f32_leaves_and_checkpoints_them(tmp_path):
    """A bf16 model's a_log and dt_bias stay f32 through a train step (f32
    gradients, f32 moments), and a checkpoint of the parameters restores
    with each leaf's dtype in both packages."""
    _, cfg = _cfgs(dtype="bfloat16", n_layers=5)
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    opt = TO.adamw(1e-3, max_grad_norm=1.0)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 16, 6).items()}
    before = params["tail"]["a_log"].clone()
    params, state, m = make_train_step(cfg, opt, accum=2)(params, state, batch)
    assert torch.isfinite(m["loss"])
    for path, t in _paths(params):
        f32 = path[-1] in ("a_log", "dt_bias")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path
    assert not torch.equal(params["tail"]["a_log"], before)
    assert all(t.dtype == torch.float32 for t in TO.optimizers.tree_leaves(state[-1].mu))
    tckpt.save_pytree(tmp_path, 1, params)
    back = tckpt.restore_pytree(tmp_path, 1, params)
    for (path, a), (_, b) in zip(_paths(params), _paths(back)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b), path
    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        JT.abstract_params(_cfgs(dtype="bfloat16", n_layers=5)[0]))
    ref = jckpt.restore_pytree(tmp_path, 1, like)
    np.testing.assert_array_equal(np.asarray(ref["tail"]["a_log"]),
                                  params["tail"]["a_log"].detach().numpy())
    assert np.asarray(ref["tail"]["a_log"]).dtype == np.float32


def test_train_cli_runs_zamba2_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "32", "--log-every", "1", "--accum", "2"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "family=hybrid" in out.stdout and "final loss" in out.stdout


# ---------------------------------------------------------------- serving
def _check_cache(got: dict, want: dict):
    assert int(got["pos"]) == int(want["pos"])
    for name in ("ssm", "conv"):
        _close(got[name], want[name], msg=name)
    for name in ("k", "v"):
        _close(got["shared"][name], want["shared"][name], msg=f"shared.{name}")
    np.testing.assert_array_equal(got["shared"]["slot_pos"].numpy(),
                                  np.asarray(want["shared"]["slot_pos"]))


@pytest.mark.parametrize("layers,attn_impl", [("4L", "chunked"), ("5L-tail", "flash")])
def test_prefill_and_decode(models, layers, attn_impl):
    """Prefill (32 tokens: two chunks) then 8 decode steps, each the
    reference's; the caches compared after prefill and after decode."""
    cfg_j, params_j, cfg_t, params_t = models[layers]
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    toks = _tokens(cfg_t, 2, 32, 10)
    prefill_j = jax.jit(lambda p, t: JT.prefill(p, cfg_j, {"tokens": t}, max_len=48))
    decode_j = jax.jit(lambda p, t, c: JT.decode_step(p, cfg_j, t, c))
    lj, cj = prefill_j(params_j, jnp.asarray(toks))
    lt, ct = TT.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks)}, max_len=48)
    assert lt.shape == (2, cfg_t.padded_vocab)
    _close(lt, lj)
    _check_cache(ct, cj)
    nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for i in range(8):
        lj, cj = decode_j(params_j, jnp.asarray(nxt[:, None]), cj)
        lt, ct = TT.decode_step(params_t, cfg_t, torch.from_numpy(nxt[:, None]), ct)
        _close(lt, lj, msg=f"decode step {i}")
        nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    _check_cache(ct, cj)


@pytest.mark.parametrize("layers", list(LAYERS))
def test_decode_follows_the_teacher_forced_oracle(models, layers):
    """8 decode steps after a 16-token prompt, each against the port's own
    full-sequence forward at ``ssm_chunk=1`` (the pure recurrence)."""
    _, _, cfg, params = models[layers]
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


def test_serving_engine_same_tokens_as_the_reference(models):
    cfg_j, params_j, cfg_t, params_t = models["5L-tail"]
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


def test_synthetic_batches_take_the_hybrid_family():
    _, cfg = _cfgs()
    b = next(ttrain.synthetic_batches(cfg, 2, 16, 1, device="cpu"))
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
