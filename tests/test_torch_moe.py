"""The port's MoE LM family (one device) against the JAX package, on the CPU.

Reduced phi3.5-moe-42b (2 layers, d_model 256, 4 heads, head_dim 64, 4
experts of d_ff 512, top-2, vocab 512, f32) and reduced dbrx-132b with 8
experts at top-4 (dbrx's own k; ``reduced()`` would cut it to 2), both
packages on the same weights: one seeded numpy draw (normal / sqrt(fan_in),
norm scales 1 + N(0, 0.1^2)) carried into each, the port's through
``convert.lm_params_from_numpy``. The flash path runs the Pallas kernels
in interpret mode on the JAX side and the plain versions on the port's.

Tolerances: router ids and the dispatch exact; router weights and aux
within 1e-6; the expert block, ``moe_ffn``, logits and caches rtol/atol
1e-4 (f32 sums in another order); loss rtol 1e-5, gradients rtol 1e-4,
atol 1e-5 x the leaf's largest (as tests/test_torch_lm_train.py); after
an AdamW step parameters within 5e-5 for 99.9% of each leaf; decode
against the port's own teacher-forced forward rtol 2e-2, atol 2e-3 (as
tests/test_models.py). The smoke test's MoE gates (``chip_smoke``) are
checked here too, each passing and failing a planted fault.
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
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serving import Request, ServingEngine

PHI = "phi3.5-moe-42b"
DBRX = "dbrx-132b"
# dbrx keeps its top-4 (on 8 experts) so a row takes four adds.
CHANGES = {PHI: {}, DBRX: {"n_experts": 8, "top_k": 4}}


def _cfgs(arch: str, **changes):
    changes = {**CHANGES[arch], **changes}
    return (dataclasses.replace(jconfigs.get(arch).reduced(), **changes),
            dataclasses.replace(tconfigs.get(arch).reduced(), **changes))


def _pair(arch: str, seed: int = 0, **changes):
    cfg_j, cfg_t = _cfgs(arch, **changes)
    rng = np.random.default_rng(seed)

    def make(path, e):
        noise = rng.standard_normal(e.shape)
        if e.init == "ones":
            return 1.0 + 0.1 * noise
        return noise / np.sqrt(e.shape[-2] if len(e.shape) >= 2 else e.shape[-1])

    arrays = TT.map_schema(make, TT.param_schema(cfg_t))
    params_j = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), arrays,
                            JT.abstract_params(cfg_j))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these models are small, and the suite runs files
    side by side, where each file's thread pool would contend for the
    same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """Both packages' models, made once for the module: each arch, chunked
    and flash configs over the same weights."""
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


def _moe_layer(params_j, params_t, i=0):
    return (jax.tree.map(lambda a: a[i], params_j["layers"]["moe"]),
            TT.layer(params_t["layers"], i)["moe"])


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ------------------------------------------------------------------- router
@pytest.mark.parametrize("arch", list(CHANGES))
def test_router_matches_the_reference(models, arch):
    cfg_j, params_j, cfg_t, params_t = models[arch]
    pj, pt = _moe_layer(params_j, params_t, 1)
    x = _x((96, cfg_t.d_model), 1)
    wj, ij, aj = JL._router(pj, jnp.asarray(x), cfg_j)
    wt, it, at = TL._router(pt, torch.from_numpy(x), cfg_t)
    assert it.shape == (96, cfg_t.top_k) and wt.dtype == torch.float32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(wt, wj, rtol=0, atol=1e-6)
    assert abs(float(at) - float(aj)) <= 1e-6


def _tied_router(cfg, seed):
    """Inputs and a router weight whose logits are exact in f32 (small
    integers times 1/64), with columns 1 and 3 equal: every token ties
    experts 1 and 3."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (64, cfg.d_model)).astype(np.float32)
    wr = (rng.integers(-4, 5, (cfg.d_model, cfg.n_experts)) / 64).astype(np.float32)
    wr[:, 3] = wr[:, 1]
    return x, wr


def test_router_breaks_a_planted_tie_as_the_reference_does(models):
    """Tied experts 1 and 3 come out lower index first, as jax.lax.top_k
    gives them: at ranks 0 and 1 where they lead, and 1 alone where they
    tie for the last place kept."""
    cfg_j, _, cfg_t, _ = models[PHI]
    x, wr = _tied_router(cfg_t, 3)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(wr), dim=-1)
    assert torch.equal(probs[:, 1], probs[:, 3])
    wj, ij, aj = JL._router({"wr": jnp.asarray(wr)}, jnp.asarray(x), cfg_j)
    wt, it, at = TL._router({"wr": torch.from_numpy(wr)}, torch.from_numpy(x), cfg_t)
    ij = np.asarray(ij)
    np.testing.assert_array_equal(it.numpy(), ij)
    assert ((ij[:, 0] == 1) & (ij[:, 1] == 3)).any()  # both kept, lower first
    ranked, p1 = np.sort(probs.numpy(), axis=1), probs[:, 1].numpy()
    second_tie = (p1 == ranked[:, -2]) & (p1 == ranked[:, -3]) & (p1 < ranked[:, -1])
    assert second_tie.any() and (ij[second_tie, 1] == 1).all()  # the tie for 2nd goes to 1
    _close(wt, wj, rtol=0, atol=1e-6)
    assert abs(float(at) - float(aj)) <= 1e-6


# ------------------------------------------------------------ expert block
def _reference_dispatch(ids: np.ndarray, e: int, capacity: int) -> np.ndarray:
    """The reference's slot rule in numpy: rank among the expert's routed
    tokens in token order; T marks an empty slot."""
    routed = (ids == e).any(axis=1)
    dispatch = np.full(capacity, ids.shape[0])
    rows = np.flatnonzero(routed)[:capacity]
    dispatch[:rows.size] = rows
    return dispatch


@pytest.mark.parametrize("arch", list(CHANGES))
def test_expert_block_drops_the_reference_s_tokens(models, arch):
    """The reference's ids and weights injected, at a capacity of 3 slots an
    expert (most tokens dropped): each expert's dispatch is the reference's
    rule, each expert alone (``e_offset``) leaves the same rows empty as the
    reference's, and the combined output matches."""
    cfg_j, params_j, cfg_t, params_t = models[arch]
    pj, pt = _moe_layer(params_j, params_t)
    x = _x((24, cfg_t.d_model), 4)
    wj, ij, _ = JL._router(pj, jnp.asarray(x), cfg_j)
    ids, weights = torch.from_numpy(np.array(ij)).long(), torch.from_numpy(np.array(wj))
    cap = 3
    dispatch, tok_w = TL.expert_dispatch(ids, weights, cfg_t.n_experts, cap)
    assert dispatch.shape == (cfg_t.n_experts, cap) and tok_w.shape == (cfg_t.n_experts, 24)
    for e in range(cfg_t.n_experts):
        np.testing.assert_array_equal(dispatch[e].numpy(),
                                      _reference_dispatch(ids.numpy(), e, cap))
        np.testing.assert_array_equal(tok_w[e].numpy(), np.where(ids.numpy() == e, wj, 0).sum(1))
        one = [w[e:e + 1] for w in (pj["wg"], pj["wu"], pj["wd"])]
        want = JL._expert_block(jnp.asarray(x), ij, wj, *one, e, cap)
        got = TL._expert_block(torch.from_numpy(x), ids, weights,
                               *(pt[n][e:e + 1] for n in ("wg", "wu", "wd")), e, cap)
        np.testing.assert_array_equal((got == 0).all(1).numpy(),
                                      (np.asarray(want) == 0).all(1), err_msg=f"expert {e}")
        assert int((~(got == 0).all(1)).sum()) == min(cap, int((ids == e).any(1).sum()))
    want = JL._expert_block(jnp.asarray(x), ij, wj, pj["wg"], pj["wu"], pj["wd"], 0, cap)
    got = TL._expert_block(torch.from_numpy(x), ids, weights, pt["wg"], pt["wu"], pt["wd"],
                           0, cap)
    _close(got, want)


@pytest.mark.parametrize("arch", list(CHANGES))
@pytest.mark.parametrize("capacity", [None, -1, 5])
def test_moe_ffn_matches_the_reference(models, arch, capacity):
    """The capacity-factor rule (here int(k T / E x 1.25): some tokens
    dropped), every token kept (-1, decode's) and a given capacity."""
    cfg_j, params_j, cfg_t, params_t = models[arch]
    pj, pt = _moe_layer(params_j, params_t)
    x = _x((2, 20, cfg_t.d_model), 5)
    oj, aj = JL.moe_ffn(pj, jnp.asarray(x), cfg_j, capacity=capacity)
    ot, at = TL.moe_ffn(pt, torch.from_numpy(x), cfg_t, capacity=capacity)
    assert ot.shape == (2, 20, cfg_t.d_model)
    _close(ot, oj)
    assert abs(float(at) - float(aj)) <= 1e-6
    assert TL.moe_capacity(cfg_t, 40, capacity) == {
        None: int(cfg_t.top_k * 40 / cfg_t.n_experts * 1.25), -1: 40, 5: 5}[capacity]


# ------------------------------------------------------ schema, init, cache
@pytest.mark.parametrize("arch", list(CHANGES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_schema_is_the_reference(arch, dtype):
    cfg_j, cfg_t = _cfgs(arch, dtype=dtype)
    want, got = {}, {}
    JT._map_schema(lambda p, e: want.setdefault(p, e), JT.param_schema(cfg_j))
    TT.map_schema(lambda p, e: got.setdefault(p, e), TT.param_schema(cfg_t))
    assert list(got) == list(want)
    abstract = JT.abstract_params(cfg_j)
    for path, e in want.items():
        assert tuple(got[path]) == (e.shape, e.axes, e.init), path
        assert str(TT.entry_dtype(cfg_t, got[path])).split(".")[-1] == \
            str(_get(abstract, path).dtype), path
    assert got[("layers", "moe", "wg")].shape == (2, cfg_t.n_experts, 256, 512)
    params = TT.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    n = sum(p.numel() for p in tree_leaves(params))
    assert n == cfg_t.param_count() + (2 * cfg_t.n_layers + 1) * cfg_t.d_model


def test_init_params_draws_each_layer_slice_with_the_stated_scale():
    """Stacked entries are drawn a leading slice at a time: each slice is its
    own N(0, 1 / fan_in) draw, seeded runs repeat bitwise, and the model
    holds them (``LanguageModel``)."""
    _, cfg = _cfgs(PHI, dtype="bfloat16")
    a = TT.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = TT.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (path, x), (_, y) in zip(_paths(a), _paths(b)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y), path
    wg = a["layers"]["moe"]["wg"].float()
    assert not torch.equal(wg[0], wg[1]) and not torch.equal(wg[0, 0], wg[0, 1])
    assert abs(float(wg.std()) * 256 ** 0.5 - 1) < 0.02
    model = TT.LanguageModel(cfg, a)
    assert model.state_dict()["layers.moe.wr"].shape == (2, 256, cfg.n_experts)


@pytest.mark.parametrize("arch", list(CHANGES))
def test_init_cache_and_structure_are_the_reference(arch):
    """The dense ring: every leaf's shape, dtype and values."""
    cfg_j, cfg_t = _cfgs(arch)
    want = JC.init_cache(cfg_j, 3, 40)
    got = init_cache(cfg_t, 3, 40, device="cpu")
    struct = cache_structure(cfg_t, 3, 40)
    assert set(got) == set(want) == {"pos", "self"}
    for name, g, w, s in [("pos", got["pos"], want["pos"], struct["pos"])] + [
            (n, got["self"][n], want["self"][n], struct["self"][n])
            for n in ("k", "v", "slot_pos")]:
        w = np.asarray(w)
        assert tuple(g.shape) == tuple(s.shape) == w.shape, name
        assert g.dtype == s.dtype and str(g.dtype).split(".")[-1] == str(w.dtype), name
        assert s.device.type == "meta"
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# --------------------------------------------------------------- training
def _batch(cfg, b, s, seed, packed=False):
    toks = _tokens(cfg, b, s + 1, seed)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if packed:  # two documents and a pad tail a row
        seg = np.zeros((b, s), np.int32)
        seg[:, :s // 3] = 1
        seg[:, s // 3:s - 5] = 2
        seg[1, :s // 2] = 1
        batch["segments"] = seg
    return batch


def _grads_t(params_t, cfg_t, batch):
    paths = list(_paths(params_t))
    leaves = [p.detach().clone().requires_grad_() for _, p in paths]
    it = iter(leaves)
    params = TT.map_schema(lambda path, e: next(it), TT.param_schema(cfg_t))
    loss, m = TT.forward_train(params, cfg_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    return paths, loss, m, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("policy,packed", [("full", False), ("dots", True)],
                         ids=["full-rows", "dots-packed"])
def test_forward_train_loss_and_gradients(models, policy, packed):
    """Loss, ce, aux and every gradient against ``jax.value_and_grad`` of the
    reference's ``forward_train`` under the same remat policy, on plain
    rows (flash) and on packed rows with pad tails (chunked, by the rule);
    T = 64 tokens at capacity int(2 x 64 / 4 x 1.25) = 40 slots. ("dots"
    on plain rows and "full" on packed ones give the same gradients bit for
    bit: ``test_dots_and_full_give_the_same_gradients_bit_for_bit``.)"""
    cfg_j, params_j, cfg_t, params_t = models[PHI]
    changes = {"remat_policy": policy, "attn_impl": "flash"}
    cfg_j, cfg_t = (dataclasses.replace(c, **changes) for c in (cfg_j, cfg_t))
    batch = _batch(cfg_t, 2, 32, 2, packed)
    (lj, mj), gj = jax.jit(jax.value_and_grad(JT.forward_train, has_aux=True),
                           static_argnums=1)(params_j, cfg_j,
                                             {k: jnp.asarray(v) for k, v in batch.items()})
    paths, lt, mt, gt = _grads_t(params_t, cfg_t, batch)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mt["ce"].detach()), float(mj["ce"]), rtol=1e-5)
    aux = float(mt["aux"].detach())
    assert abs(aux - float(mj["aux"])) <= 1e-6 and aux > 0
    for (path, _), g in zip(paths, gt):
        w = np.asarray(_get(gj, path))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=".".join(path))
    wr = gt[[p for p, _ in paths].index(("layers", "moe", "wr"))]
    assert all(float(wr[i].abs().max()) > 0 for i in range(cfg_t.n_layers))


@pytest.mark.parametrize("packed", [False, True], ids=["rows", "packed"])
def test_dots_and_full_give_the_same_gradients_bit_for_bit(models, packed):
    """"dots" returns the saved 2-D products (the experts' and the router's
    among them) where "full" recomputes them: loss and gradients bitwise,
    and both bitwise no remat."""
    _, _, cfg, params = models[DBRX]
    batch = _batch(cfg, 2, 16, 3, packed)
    out = [_grads_t(params, dataclasses.replace(cfg, **c), batch)
           for c in ({"remat_policy": "dots"}, {"remat_policy": "full"}, {"remat": False})]
    for _, loss, _, grads in out[1:]:
        assert torch.equal(loss, out[0][1])
        for a, b in zip(grads, out[0][3]):
            assert torch.equal(a, b)


def test_train_step_matches_reference():
    """One AdamW step (the train CLI's recipe, accum 2) through both
    packages' ``make_train_step``: loss, ce and aux, then the parameters."""
    cfg_j, params_j, cfg_t, params_t = _pair(PHI, seed=1)
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
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5)
    assert abs(float(mt["aux"]) - float(mj["aux"])) <= 1e-6
    for path, p in _paths(pt):
        diff = np.abs(p.detach().numpy() - np.asarray(_get(pj, path)))
        assert (diff > 5e-5).mean() <= 1e-3, ".".join(path)
        assert diff.max() <= 2 * 5e-3, ".".join(path)


@pytest.mark.parametrize("arch", list(CHANGES))
def test_train_cli_runs_moe_on_the_cpu(arch, capsys):
    losses = ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "family=moe" in out and "aux=" in out and "ce=" in out
    aux = [float(line.split("aux=")[1].split()[0]) for line in out.splitlines()
           if line.startswith("step")]
    assert len(aux) == 2 and all(0 < a <= 2 for a in aux)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("arch,attn_impl", [(PHI, "chunked"), (DBRX, "flash")])
def test_prefill_and_decode(models, arch, attn_impl):
    """Prefill (24 tokens, some dropped by the capacity rule) then 6 decode
    steps (every token kept), each the reference's; the caches after each."""
    cfg_j, params_j, cfg_t, params_t = models[arch]
    cfg_j, cfg_t = (dataclasses.replace(c, attn_impl=attn_impl) for c in (cfg_j, cfg_t))
    toks = _tokens(cfg_t, 2, 24, 10)
    prefill_j = jax.jit(lambda p, t: JT.prefill(p, cfg_j, {"tokens": t}, max_len=32))
    decode_j = jax.jit(lambda p, t, c: JT.decode_step(p, cfg_j, t, c))
    lj, cj = prefill_j(params_j, jnp.asarray(toks))
    lt, ct = TT.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks)}, max_len=32)
    assert lt.shape == (2, cfg_t.padded_vocab)

    def same_cache():
        assert int(ct["pos"]) == int(cj["pos"])
        for n in ("k", "v"):
            _close(ct["self"][n], cj["self"][n], msg=n)
        np.testing.assert_array_equal(ct["self"]["slot_pos"].numpy(),
                                      np.asarray(cj["self"]["slot_pos"]))
    _close(lt, lj)
    same_cache()
    nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for i in range(6):
        lj, cj = decode_j(params_j, jnp.asarray(nxt[:, None]), cj)
        lt, ct = TT.decode_step(params_t, cfg_t, torch.from_numpy(nxt[:, None]), ct)
        _close(lt, lj, msg=f"decode step {i}")
        nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    same_cache()


def test_decode_follows_the_teacher_forced_oracle(models):
    """8 decode steps after a 16-token prompt, each against the port's own
    full-sequence forward; the capacity lossless everywhere (prefill,
    decode and the oracle route the same function)."""
    _, _, cfg, params = models[DBRX]
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    s, extra = 16, 8
    toks = torch.from_numpy(_tokens(cfg, 2, s + extra, 11))
    _, cache = TT.prefill(params, cfg, {"tokens": toks[:, :s]}, max_len=s + extra)
    with torch.no_grad():
        h, _ = TT.backbone_train(params, cfg, params["embed"][toks.long()])
        oracle = TT._logits(params, cfg, h)
    for i in range(extra):
        lg, cache = TT.decode_step(params, cfg, toks[:, s + i:s + i + 1], cache)
        np.testing.assert_allclose(lg.numpy(), oracle[:, s + i].numpy(), rtol=2e-2, atol=2e-3,
                                   err_msg=f"divergence at decode step {i}")


def test_serving_engine_same_tokens_as_the_reference(models):
    cfg_j, params_j, cfg_t, params_t = models[PHI]
    sizes = [(16, 6), (16, 4), (16, 3), (16, 5), (16, 2)]

    def reqs(cls, cfg):
        return [cls(uid=i, prompt=_tokens(cfg, 1, p, 20 + i)[0], max_new_tokens=n)
                for i, (p, n) in enumerate(sizes)]

    got = ServingEngine(cfg_t, params_t, slots=4, max_len=48, device="cpu").run(
        reqs(Request, cfg_t))
    want = JServingEngine(cfg_j, params_j, slots=4, max_len=48).run(reqs(JRequest, cfg_j))
    assert [c.uid for c in got] == [c.uid for c in want] == list(range(len(sizes)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens), err_msg=f"uid {g.uid}")


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-1.2b", PHI])
def test_serve_cli_runs_lm_on_the_cpu(arch, capsys):
    """The LM form of the serve CLI: prefill, greedy decode, the printout,
    every token in the vocab."""
    tokens = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "32", "--gen", "5"])
    out = capsys.readouterr().out
    cfg = tconfigs.get(arch).reduced()
    assert tokens.shape == (2, 5) and tokens.min() >= 0 and tokens.max() < cfg.vocab_size
    assert f"{cfg.name}: prefill 2x32" in out and "sample:" in out


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
def test_moe_specs_are_the_reference_s(arch, mesh):
    """``param_specs`` (both rule tables; the experts on 'model'),
    ``cache_specs`` and ``data_specs`` at full size."""
    tmesh, jmesh = make_dry_mesh(MESHES[mesh]), FakeMesh(MESHES[mesh])
    cfg_t, cfg_j = tconfigs.get(arch), jconfigs.get(arch)
    for rules_t, rules_j in ((None, None), (TSH.serving_rules(), JSH.serving_rules())):
        _same_specs(TSH.param_specs(cfg_t, tmesh, rules_t),
                    JSH.param_specs(cfg_j, jmesh, rules_j), arch)
    assert TSH.param_specs(cfg_t, tmesh)["layers"]["moe"]["wg"][1] == "model"
    for b, s in ((128, 32_768), (1, 524_288), (3, 1000)):
        _same_specs(TSH.cache_specs(cfg_t, tmesh, b, s), JSH.cache_specs(cfg_j, jmesh, b, s),
                    f"{arch} cache {b}x{s}")
    for b in (1, 3, 32):
        _same_specs(TSH.data_specs(cfg_t, tmesh, b), JSH.data_specs(cfg_j, jmesh, b),
                    f"{arch} data {b}")


# ------------------------------------------------------- the smoke's gates
@pytest.fixture
def moe_train_cpu(monkeypatch):
    """The smoke's MoE helpers on the CPU at reduced phi3.5-moe (2 layers,
    bf16, flash): the card's memory and sync calls stubbed, the plain flash
    forward and backward counted as wgmma launches (the CPU launches no
    kernel)."""
    from repro_torch.kernels import flash_attention, ops

    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None), ("max_memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)
    chip_smoke.reset_counts()
    fwd, bwd = ops.flash_attention, flash_attention.flash_attention_bwd

    def fwd_counted(*args, **kw):
        flash_attention.launches += 1
        flash_attention.route_launches["wgmma"] += 1
        return fwd(*args, **kw)

    def bwd_counted(*args, **kw):
        flash_attention.bwd_launches += 1
        flash_attention.bwd_route_launches["wgmma"] += 1
        return bwd(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", fwd_counted)
    monkeypatch.setattr(flash_attention, "flash_attention_bwd", bwd_counted)
    yield dataclasses.replace(tconfigs.get(PHI).reduced(), dtype="bfloat16", attn_impl="flash")
    chip_smoke.reset_counts()


def test_smoke_moe_run_gates_pass_and_fail_planted_faults(moe_train_cpu):
    """Two seeded runs of run A's recipe at accum 2 pass the MoE run gates
    (bitwise, falling loss, aux in (0, L], 2L + L flash launches a
    microbatch), then fail a parameter off by one bf16 ulp and a missing
    recompute launch."""
    cfg = moe_train_cpu
    batches = list(chip_smoke.synthetic_batches(cfg, 2, 24, 3, seed=0, device="cpu"))
    recipe = chip_smoke.adamw(chip_smoke.cosine_schedule(1e-2, 1, 3), weight_decay=0.01,
                              max_grad_norm=1.0)
    runs, copies = [], []
    for _ in range(2):
        res, params, _, _, _ = chip_smoke.train_lm(cfg, recipe, batches, 2, 0.0, "cpu")
        runs.append(res)
        copies.append(chip_smoke.param_copy(params))
    chip_smoke.check_lm_runs("moe", runs, copies, cfg.n_layers, 2, cfg.n_layers)
    off = [c.clone() for c in copies[1]]
    off[5].view(torch.int16).view(-1)[7] += 1  # one bf16 ulp
    with pytest.raises(AssertionError, match="parameter leaf 5 differs"):
        chip_smoke.check_lm_runs("moe", runs, [copies[0], off], cfg.n_layers, 2,
                                 cfg.n_layers)
    short = dict(runs[1], fwd_launches=[2 * cfg.n_layers] * 3)  # no recompute launches
    with pytest.raises(AssertionError, match="flash launches a step"):
        chip_smoke.check_lm_runs("moe", [runs[0], short], copies, cfg.n_layers, 2,
                                 cfg.n_layers)
    high = dict(runs[0], aux=[0.5, 2.5, 0.5])
    with pytest.raises(AssertionError, match="router aux"):
        chip_smoke.check_lm_runs("moe", [high, runs[1]], copies, cfg.n_layers, 2,
                                 cfg.n_layers)


def test_smoke_dispatch_gate_passes_and_fails_a_changed_dispatch(monkeypatch):
    """The dispatch gate compares every expert's dispatch on two devices
    (here the CPU twice): it passes, and fails one that swaps two slots."""
    cfg = dataclasses.replace(tconfigs.get(PHI).reduced(), dtype="bfloat16")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 2, 48, 3))
    xin = chip_smoke.moe_inputs(cfg, params, tokens)
    weights, ids, _ = TL._router(TT.layer(params["layers"], 0)["moe"], xin, cfg)
    cap = TL.moe_capacity(cfg, ids.shape[0])
    out = chip_smoke.check_moe_dispatch(cfg, ids, weights, cap, "cpu")
    assert sum(out["kept"]) + sum(out["dropped"]) == cfg.top_k * 96
    assert all(k <= cap for k in out["kept"])
    inner, calls = TL.expert_dispatch, []

    def swapped(ids, weights, n_experts, capacity):
        dispatch, tok_w = inner(ids, weights, n_experts, capacity)
        calls.append(1)
        if len(calls) == 1:  # the first device's: two slots of expert 1 swapped
            dispatch = dispatch.clone()
            dispatch[1, :2] = dispatch[1, :2].flip(0)
        return dispatch, tok_w
    monkeypatch.setattr(chip_smoke.lm_layers, "expert_dispatch", swapped)
    with pytest.raises(AssertionError, match="expert 1: the dispatch"):
        chip_smoke.check_moe_dispatch(cfg, ids, weights, cap, "cpu")


def test_smoke_router_gradient_gate_fails_a_detached_router(monkeypatch):
    cfg = tconfigs.get(PHI).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 16, 4).items()}
    out = chip_smoke.check_router_grads(cfg, params, batch)
    assert len(out["wr_grad_norm_by_layer"]) == 2 and out["aux"] > 0
    router = TL._router

    def detached(p, xf, c):
        w, i, a = router({"wr": p["wr"].detach()}, xf, c)
        return w, i, a
    monkeypatch.setattr(TL, "_router", detached)
    with pytest.raises(AssertionError, match="router gradients"):
        chip_smoke.check_router_grads(cfg, params, batch)


def test_smoke_route_agreement_masks_rows_routed_otherwise():
    same = torch.tensor([[[0, 1], [2, 3]], [[1, 2], [0, 3]]])  # (rows, layers, k)
    other = same.clone()
    other[1, 1] = torch.tensor([0, 2])
    assert chip_smoke.route_agreement("t", [same, same, None], (2,)).tolist() == [True, True]
    assert chip_smoke.route_agreement("t", [None], (3,)).all()  # no router
    rows = torch.cat([same] * 2)
    mask = chip_smoke.route_agreement("t", [rows, torch.cat([same, other])], (4,))
    assert mask.tolist() == [True, True, True, False]
    with pytest.raises(AssertionError, match="routings agree on 2 of 4"):
        chip_smoke.route_agreement("t", [rows, torch.cat([other, other])], (4,))


@pytest.fixture
def moe_drift(monkeypatch):
    """A small bf16 MoE model's decode gate at lossless capacity: 2 x 32-token
    prompts, 8 new tokens, on the CPU."""
    monkeypatch.setattr(chip_smoke, "LM_MAX_LEN", 48)
    monkeypatch.setattr(chip_smoke, "LM_NEW", 8)
    cfg = dataclasses.replace(tconfigs.get(PHI).reduced(), dtype="bfloat16", attn_impl="flash")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, _tokens(cfg, 2, 32, 6)


def test_smoke_moe_decode_drift_passes_and_fails_an_unwritten_ring(moe_drift, monkeypatch):
    """The decode gate passes on the small model (every step compared over
    the rows routed alike) and fails a decode that never writes the K/V
    ring (its attention then misses every generated token)."""
    cfg, params, prompts = moe_drift
    out = chip_smoke.decode_drift(cfg, params, prompts, None, "cpu")
    assert out["worst_ratio"] <= 2 and out["pairs_compared"] >= 0.75 * out["pairs"] == 12
    inner = TL.self_attention_decode

    def unwritten(p, x, k, v, slot_pos, pos, c, window):
        return inner(p, x, k.clone(), v.clone(), slot_pos.clone(), pos, c, window)
    monkeypatch.setattr(TL, "self_attention_decode", unwritten)
    with pytest.raises(AssertionError, match="drift|routings agree"):
        chip_smoke.decode_drift(cfg, params, prompts, None, "cpu")
