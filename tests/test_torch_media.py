"""The port's media families against the JAX package, on the CPU: the VLM
(llama-3.2-vision: groups of dense self layers closed by a gated
cross-attention layer) and audio (whisper: a bidirectional encoder over
the media, decoder layers of self, cross and MLP).

Reduced llama-3.2-vision-90b cut to 6 layers in 2 groups of 2 self
layers + 1 cross layer (so the group-major ring and the two-deep stack
are not trivial), d_model 256, 4 q heads on 4 kv heads, head_dim 64,
16 media tokens, vocab 512, f32; reduced whisper-small (2 encoder and 2
decoder layers, the same widths). Both packages take one seeded numpy
draw of the weights (normal / sqrt(fan_in), norm scales 1 + N(0,
0.1^2)); every cross layer's gates are set non-zero, ``gate_attn`` 0.5
and ``gate_mlp`` -0.3 in both (at their init of 0 a VLM cross layer is
the identity and the media would change nothing). The flash path runs
the Pallas kernels in interpret mode on the JAX side and the plain
versions on the port's; the encoder and cross attention are plain
chunked attention in both.

Tolerances: logits, caches and media K/V rtol/atol 1e-4 (f32 sums in
another order); loss rtol 1e-5; gradients rtol 1e-4, atol 1e-5 x the
leaf's largest (as tests/test_torch_lm_train.py); after an AdamW step
parameters within 5e-5 for 99.9% of each leaf; batches, slot positions,
``pos``, served tokens and specs exact. The smoke test's media gates
(``chip_smoke``) are checked here too, each passing and failing a
planted fault.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import chip_smoke
import repro.configs as jconfigs
import repro.optim as JO
import repro.sharding as JSH
import repro_torch.configs as tconfigs
import repro_torch.optim as TO
import repro_torch.sharding as TSH
from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import cache as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.cache import cache_structure, init_cache
from repro_torch.serving import Request, ServingEngine

VLM = "llama-3.2-vision-90b"
AUDIO = "whisper-small"
CHANGES = {VLM: {"n_layers": 6, "cross_attn_every": 3}, AUDIO: {}}
GATES = {"gate_attn": 0.5, "gate_mlp": -0.3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these models are small, and the suite runs files
    side by side, where each file's thread pool would contend for the
    same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch: str, **changes):
    changes = {**CHANGES[arch], **changes}
    return (dataclasses.replace(jconfigs.get(arch).reduced(), **changes),
            dataclasses.replace(tconfigs.get(arch).reduced(), **changes))


def _pair(arch: str, seed: int = 0, **changes):
    """Both packages' parameters from one seeded numpy draw, in each
    entry's dtype; the cross layers' gates at ``GATES``."""
    cfg_j, cfg_t = _cfgs(arch, **changes)
    rng = np.random.default_rng(seed)

    def make(path, e):
        if path[-1] in GATES:
            return np.full(e.shape, GATES[path[-1]])
        noise = rng.standard_normal(e.shape)
        if e.init == "ones":
            return 1.0 + 0.1 * noise
        return noise / np.sqrt(e.shape[-2] if len(e.shape) >= 2 else e.shape[-1])

    arrays = TT.map_schema(make, TT.param_schema(cfg_t))
    params_j = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), arrays,
                            JT.abstract_params(cfg_j))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(arch) for arch in CHANGES}


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


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _media(cfg, b, seed):
    return (np.random.default_rng(seed).standard_normal((b, cfg.n_media_tokens, cfg.d_model))
            * 0.5).astype(np.float32)


def _batch(cfg, b, s, seed):
    toks = _tokens(cfg, b, s + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "media": _media(cfg, b, seed + 100)}


# ---------------------------------------------------------- schema and cache
@pytest.mark.parametrize("arch", list(CHANGES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_schema_is_the_reference(arch, dtype):
    """The same names in the same order, each entry's shape, axes and init,
    and each leaf's dtype (``abstract_params`` against ``init_params``)."""
    cfg_j, cfg_t = _cfgs(arch, dtype=dtype)
    want, got = {}, {}
    JT._map_schema(lambda p, e: want.setdefault(p, e), JT.param_schema(cfg_j))
    TT.map_schema(lambda p, e: got.setdefault(p, e), TT.param_schema(cfg_t))
    assert list(got) == list(want)
    for path, e in want.items():
        assert tuple(got[path]) == (e.shape, e.axes, e.init), path
    abstract = JT.abstract_params(cfg_j)
    params = TT.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    for path, t in _paths(params):
        a = _get(abstract, path)
        assert tuple(t.shape) == a.shape and str(t.dtype).split(".")[-1] == str(a.dtype), path
    if arch == VLM:
        assert params["groups"]["self"]["attn"]["wq"].shape[:2] == (2, 2)
        for gate in GATES:  # zero at init: a fresh cross layer is the identity
            assert params["groups"]["cross"][gate].shape == (2,)
            assert not params["groups"]["cross"][gate].any()
    else:
        assert set(params) >= {"encoder", "decoder", "enc_ln"}


@pytest.mark.parametrize("arch", list(CHANGES))
def test_conversion_carries_the_reference_s_init_bit_for_bit(arch):
    cfg_j, cfg_t = _cfgs(arch)
    params_j = JT.init_params(cfg_j, jax.random.PRNGKey(3))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    for path, t in _paths(params_t):
        np.testing.assert_array_equal(t.numpy(), np.asarray(_get(params_j, path)),
                                      err_msg=".".join(path))
    model = TT.LanguageModel(cfg_t, params_t)
    assert set(model.state_dict()) == {".".join(p) for p, _ in _paths(params_t)}


@pytest.mark.parametrize("arch", list(CHANGES))
def test_init_cache_and_structure_are_the_reference(arch):
    cfg_j, cfg_t = _cfgs(arch)
    want = JC.init_cache(cfg_j, 3, 40)
    for got in (init_cache(cfg_t, 3, 40, device="cpu"), cache_structure(cfg_t, 3, 40)):
        assert sorted(p for p, _ in _paths(got)) == sorted(p for p, _ in _paths(want))
        for path, t in _paths(got):
            w = _get(want, path)
            assert tuple(t.shape) == tuple(w.shape), path
            assert str(t.dtype).split(".")[-1] == str(w.dtype), path
            if t.device.type == "cpu":
                np.testing.assert_array_equal(t.numpy(), np.asarray(w), err_msg=str(path))
    g = 2 if arch == VLM else cfg_t.n_layers
    assert cache_structure(cfg_t, 3, 40)["media_k"].shape[0] == g


# ------------------------------------------------------------------ batches
@pytest.mark.parametrize("arch", list(CHANGES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_batches_are_the_reference_s_bit_for_bit(arch, dtype):
    """Three steps: each step's media drawn after its tokens shifts every
    later step's tokens, in both packages alike; the media's bits after the
    cast to the model's dtype."""
    cfg_j, cfg_t = _cfgs(arch, dtype=dtype)
    got = list(ttrain.synthetic_batches(cfg_t, 2, 8, 3, seed=1, device="cpu"))
    want = list(jtrain.synthetic_batches(cfg_j, 2, 8, 3, seed=1))
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens", "labels", "media"}
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        assert str(g["media"].dtype).split(".")[-1] == str(w["media"].dtype) == dtype
        np.testing.assert_array_equal(g["media"].view(torch.int16 if dtype == "bfloat16"
                                                      else torch.int32).numpy(),
                                      np.asarray(w["media"]).view(
                                          np.int16 if dtype == "bfloat16" else np.int32))


# ----------------------------------------------------------------- layers
def test_encoder_and_cross_attention_match_the_reference(models):
    cfg_j, params_j, cfg_t, params_t = models[AUDIO]
    pj = jax.tree.map(lambda a: a[0], params_j["decoder"]["xattn"])
    pt = TT.layer(params_t["decoder"]["xattn"], 0)
    x, media = _media(cfg_t, 2, 1)[:, :12], _media(cfg_t, 2, 2)
    got = TL.cross_attention(pt, torch.from_numpy(x), torch.from_numpy(media), cfg_t)
    _close(got, JL.cross_attention(pj, jnp.asarray(x), jnp.asarray(media), cfg_j))
    k = (torch.from_numpy(media) @ pt["wk"]).reshape(2, -1, cfg_t.n_kv_heads, cfg_t.head_dim)
    v = (torch.from_numpy(media) @ pt["wv"]).reshape(2, -1, cfg_t.n_kv_heads, cfg_t.head_dim)
    assert torch.equal(TL.cross_attention(pt, torch.from_numpy(x), (k, v), cfg_t), got)
    pe = TT.layer(params_t["encoder"]["attn"], 1)
    pje = jax.tree.map(lambda a: a[1], params_j["encoder"]["attn"])
    _close(TL.encoder_attention(pe, torch.from_numpy(media), cfg_t),
           JL.encoder_attention(pje, jnp.asarray(media), cfg_j))


# --------------------------------------------------------------- training
def _grads_t(params_t, cfg_t, batch):
    paths = list(_paths(params_t))
    leaves = [p.detach().clone().requires_grad_() for _, p in paths]
    it = iter(leaves)
    params = TT.map_schema(lambda path, e: next(it), TT.param_schema(cfg_t))
    loss, m = TT.forward_train(params, cfg_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, m, paths, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch,attn_impl", [(VLM, "flash"), (AUDIO, "chunked")])
def test_forward_train_loss_and_gradients(models, arch, attn_impl):
    """The loss and every gradient (the gates' and the cross projections'
    among them, all non-zero) against ``jax.grad`` of the reference."""
    cfg_j, params_j, cfg_t, params_t = models[arch]
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    batch = _batch(cfg_t, 2, 24, 2)
    (lj, _), gj = jax.jit(jax.value_and_grad(JT.forward_train, has_aux=True),
                          static_argnums=1)(params_j, cfg_j,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    lt, mt, paths, gt = _grads_t(params_t, cfg_t, batch)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert float(mt["aux"]) == 0.0
    for (path, _), g in zip(paths, gt):
        w = np.asarray(_get(gj, path))
        assert np.abs(w).max() > 0, ".".join(path)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=".".join(path))


@pytest.mark.parametrize("arch", list(CHANGES))
def test_remat_and_dots_give_the_same_gradients_and_segments_raise(models, arch):
    """Checkpointed groups (VLM) and layers (audio) against no remat, and
    remat_policy="dots" (not read by these families, as in the reference),
    bit for bit; packed segments raise ``ValueError``."""
    _, _, cfg, params = models[arch]
    batch = _batch(cfg, 2, 16, 3)
    grads = [_grads_t(params, dataclasses.replace(cfg, **c), batch)[3]
             for c in ({"remat": True}, {"remat": False}, {"remat_policy": "dots"})]
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert torch.equal(a, b)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="recurrent families"):
        TT.forward_train(params, cfg, {**tb, "segments": tb["tokens"]})


@pytest.mark.parametrize("arch", list(CHANGES))
def test_train_step_matches_reference(arch):
    """One AdamW step at accum 2 (the media split with the tokens) through
    both packages' ``make_train_step``."""
    cfg_j, params_j, cfg_t, params_t = _pair(arch, seed=4)
    batch = _batch(cfg_t, 4, 16, 5)

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


@pytest.mark.parametrize("arch", list(CHANGES))
def test_train_cli_runs_the_family_on_the_cpu(arch, capsys):
    losses = ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--log-every", "1", "--accum", "2"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert f"family={tconfigs.get(arch).family}" in out and "final loss" in out


# ---------------------------------------------------------------- serving
def _check_cache(got: dict, want: dict):
    assert int(got["pos"]) == int(want["pos"])
    for path, w in _paths({k: v for k, v in want.items() if k != "pos"}):
        g = _get(got, path)
        if path[-1] == "slot_pos":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, msg=".".join(path))


@pytest.mark.parametrize("arch,attn_impl", [(VLM, "chunked"), (AUDIO, "flash")])
def test_prefill_and_decode(models, arch, attn_impl):
    """Prefill (20 tokens) then 8 decode steps, each step's logits the
    reference's; every cache leaf (the ring, slot positions, media K/V)
    compared after prefill and after decode."""
    cfg_j, params_j, cfg_t, params_t = models[arch]
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    toks, media = _tokens(cfg_t, 2, 20, 10), _media(cfg_t, 2, 11)
    prefill_j = jax.jit(lambda p, t, m: JT.prefill(p, cfg_j, {"tokens": t, "media": m},
                                                   max_len=32))
    decode_j = jax.jit(lambda p, t, c: JT.decode_step(p, cfg_j, t, c))
    lj, cj = prefill_j(params_j, jnp.asarray(toks), jnp.asarray(media))
    lt, ct = TT.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks),
                                          "media": torch.from_numpy(media)}, max_len=32)
    _close(lt, lj)
    _check_cache(ct, cj)
    nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for i in range(8):
        lj, cj = decode_j(params_j, jnp.asarray(nxt[:, None]), cj)
        lt, ct = TT.decode_step(params_t, cfg_t, torch.from_numpy(nxt[:, None]), ct)
        _close(lt, lj, msg=f"decode step {i}")
        nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    _check_cache(ct, cj)


@pytest.mark.parametrize("arch", list(CHANGES))
def test_serving_engine_same_tokens_as_the_reference_with_and_without_media(models, arch):
    """Requests with media and without (zeros, as the pad slots get): the
    port's tokens are the reference engine's; the same prompt with other
    media gives other logits."""
    cfg_j, params_j, cfg_t, params_t = models[arch]
    sizes = [(16, 6, 1), (16, 4, None), (16, 5, 2), (12, 6, 3), (16, 3, None)]

    def reqs(cls, cfg):
        return [cls(uid=i, prompt=_tokens(cfg, 1, p, 20 + i)[0], max_new_tokens=n,
                    media=None if m is None else _media(cfg, 1, m)[0])
                for i, (p, n, m) in enumerate(sizes)]

    got = ServingEngine(cfg_t, params_t, slots=4, max_len=48, device="cpu").run(
        reqs(Request, cfg_t))
    want = JServingEngine(cfg_j, params_j, slots=4, max_len=48).run(reqs(JRequest, cfg_j))
    assert [c.uid for c in got] == [c.uid for c in want] == list(range(len(sizes)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens), err_msg=f"uid {g.uid}")
    prompt = torch.from_numpy(np.repeat(_tokens(cfg_t, 1, 16, 30), 2, axis=0))
    media = torch.from_numpy(_media(cfg_t, 2, 31))
    logits, _ = TT.prefill(params_t, cfg_t, {"tokens": prompt, "media": media})
    assert (logits[0] - logits[1]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", list(CHANGES))
def test_serve_cli_runs_the_family_on_the_cpu(arch, capsys):
    tokens = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "16", "--gen", "4"])
    cfg = tconfigs.get(arch).reduced()
    assert tokens.shape == (2, 4) and tokens.min() >= 0 and tokens.max() < cfg.vocab_size
    assert f"{cfg.name}: prefill 2x16" in capsys.readouterr().out


# ------------------------------------------------------------------- specs
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16},
          "small": {"data": 2, "model": 4}}


@dataclasses.dataclass
class FakeMesh:
    shape: dict


def _same_specs(got, want, where=""):
    """The port's spec tree leaf for leaf the reference's (trailing Nones
    stripped, as the port normalises them)."""
    if isinstance(want, JP):
        parts = list(want)
        while parts and parts[-1] is None:
            parts.pop()
        assert tuple(got) == tuple(parts), f"{where}: {got} vs {want}"
    else:
        assert set(got) == set(want), where
        for k in want:
            _same_specs(got[k], want[k], f"{where}.{k}")


@pytest.mark.parametrize("arch", list(CHANGES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_media_specs_are_the_reference_s(arch, mesh):
    """``param_specs`` (both rule tables), ``cache_specs`` (the media K/V
    among them) and ``data_specs`` (media) at full size."""
    tmesh, jmesh = make_dry_mesh(MESHES[mesh]), FakeMesh(MESHES[mesh])
    cfg_t, cfg_j = tconfigs.get(arch), jconfigs.get(arch)
    for rules_t, rules_j in ((None, None), (TSH.serving_rules(), JSH.serving_rules())):
        _same_specs(TSH.param_specs(cfg_t, tmesh, rules_t),
                    JSH.param_specs(cfg_j, jmesh, rules_j), arch)
    for b, s in ((128, 32_768), (1, 4096), (3, 1000)):
        _same_specs(TSH.cache_specs(cfg_t, tmesh, b, s), JSH.cache_specs(cfg_j, jmesh, b, s),
                    f"{arch} cache {b}x{s}")
    for b in (1, 3, 32):
        _same_specs(TSH.data_specs(cfg_t, tmesh, b), JSH.data_specs(cfg_j, jmesh, b),
                    f"{arch} data {b}")
    assert "media" in TSH.data_specs(cfg_t, tmesh, 32)


# ------------------------------------------------------- the smoke's gates
def test_smoke_media_gates_pass_and_fail_planted_faults():
    """On a small bf16 VLM: two media change the prefill logits, the caches
    hold their layout's bytes and every cross projection and gate gets a
    gradient; each gate fails its planted fault (gates at their init of 0,
    a wrong media stack, a cross layer whose gate is detached)."""
    cfg = dataclasses.replace(_cfgs(VLM, dtype="bfloat16")[1], attn_impl="flash")
    params = chip_smoke.media_params(cfg, device="cpu")
    assert float(params["groups"]["cross"]["gate_attn"][1]) == GATES["gate_attn"]
    prompt = _tokens(cfg, 1, 16, 40)[0]
    out = chip_smoke.media_changes_logits(cfg, params, prompt, 24, "cpu")
    assert out["max_abs_diff"] > 0
    closed = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(AssertionError, match="same prefill logits"):
        chip_smoke.media_changes_logits(cfg, closed, prompt, 24, "cpu")
    reqs = [Request(uid=i, prompt=prompt, media=chip_smoke.media_of(cfg, i)) for i in range(2)]
    _, cache = TT.prefill(params, cfg, chip_smoke.wave_batch(cfg, reqs, "cpu"), max_len=24)
    sizes = chip_smoke.media_cache_bytes(cfg, cache, 4, 2, 2, 24)
    assert sizes["media_bytes"] == 2 * 2 * 2 * cfg.n_media_tokens * cfg.kv_dim * 2
    with pytest.raises(AssertionError, match="media caches"):
        chip_smoke.media_cache_bytes(cfg, cache, 4, 4, 2, 24)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 16, 41).items()}
    batch["media"] = batch["media"].to(torch.bfloat16)
    picks = chip_smoke.vlm_grad_picks(cfg)
    assert len(picks) == 2 * 6
    chip_smoke.leaf_grads(cfg, params, batch, picks)
    cross = TT._cross_block

    def detached(p, x, media, c):
        return cross({**p, "gate_attn": p["gate_attn"].detach()}, x, media, c)
    import unittest.mock
    with unittest.mock.patch.object(TT, "_cross_block", detached), \
            pytest.raises(AssertionError, match="gate_attn"):
        chip_smoke.leaf_grads(cfg, params, batch, picks)
