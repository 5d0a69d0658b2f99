"""The port's dense LM zoo against the JAX package, on the CPU.

Reduced granite-3-2b (2 layers, d_model 256, 4 heads on 4 kv heads,
head_dim 64, f32) and reduced h2o-danube-1.8b (the same widths with a
64-token sliding window), with the JAX package's ``init_params`` carried
across by ``convert.lm_params_from_numpy``. The flash path runs the
Pallas kernel in interpret mode on the JAX side and the plain version on
the port's. Tolerances: norms and rope rtol 1e-5, atol 1e-6 (one or two
f32 roundings apart); attention outputs, logits and cache K/V rtol 1e-4,
atol 1e-4 (sums in another order through two layers); slot positions and
``pos`` exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as JM
import repro_torch.configs as tconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.cache import init_cache

ARCHS = list(jconfigs.ALIASES)
NOT_DENSE = [a for a in ARCHS if jconfigs.get(a).family not in ("dense", "moe", "hybrid")]


def _pair(arch: str, attn_impl: str = "chunked"):
    cfg_j = dataclasses.replace(jconfigs.get(arch).reduced(), attn_impl=attn_impl)
    cfg_t = dataclasses.replace(tconfigs.get(arch).reduced(), attn_impl=attn_impl)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-3-2b")


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_registry_is_the_reference(arch):
    a, b = tconfigs.get(arch), jconfigs.get(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    for c, d in ((a, b), (a.reduced(), b.reduced())):
        assert (c.padded_vocab, c.q_dim, c.kv_dim, c.param_count()) == (
            d.padded_vocab, d.q_dim, d.kv_dim, d.param_count())
        for s in (1, 64, 4096, 300_000):
            assert c.window_for(s) == d.window_for(s)


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_other_families_are_not_ported_yet(arch):
    """Every family is ported now (the VLM and audio ones:
    tests/test_torch_media.py; xLSTM: tests/test_torch_xlstm.py): the
    schema is the reference's, name for name, and the cache's leaves have
    the shapes of its layout. A family the zoo does not have raises
    ``ValueError``, as the reference's schema does."""
    cfg = tconfigs.get(arch).reduced()
    cfg_j = jconfigs.get(arch).reduced()
    want, got = {}, {}
    JT._map_schema(lambda p, e: want.setdefault(p, e), JT.param_schema(cfg_j))
    TT.map_schema(lambda p, e: got.setdefault(p, e), TT.param_schema(cfg))
    assert {p: tuple(e) for p, e in got.items()} == {p: tuple(e) for p, e in want.items()}
    cache = init_cache(cfg, 1, 8, device="cpu")
    if cfg.family in ("vlm", "audio"):
        assert tuple(cache["media_k"].shape[2:]) == (cfg.n_media_tokens, cfg.n_kv_heads,
                                                     cfg.head_dim)
    else:
        assert tuple(cache["mlstm"]["c"].shape[2:]) == (1, cfg.n_heads, cfg.head_dim,
                                                        cfg.head_dim)
    unknown = dataclasses.replace(cfg, family="rwkv")
    with pytest.raises(ValueError, match="unknown model family 'rwkv'"):
        TT.param_schema(unknown)
    with pytest.raises(ValueError, match="unknown model family"):
        init_cache(unknown, 1, 8, device="cpu")


def test_param_schema_is_the_reference(granite):
    cfg_j, params_j, cfg_t, params_t = granite
    want, got = {}, {}
    JT._map_schema(lambda p, e: want.setdefault(p, e), JT.param_schema(cfg_j))
    TT.map_schema(lambda p, e: got.setdefault(p, e), TT.param_schema(cfg_t))
    assert list(got) == list(want)  # the same names in the same (draw) order
    for path, e in want.items():
        assert tuple(got[path]) == (e.shape, e.axes, e.init)


def test_init_params_scaling():
    cfg = tconfigs.get("granite-3-2b").reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    wq, wd = params["layers"]["attn"]["wq"], params["layers"]["mlp"]["wd"]
    assert wq.shape == (2, 256, 256) and wq.dtype == torch.float32
    assert abs(float(wq.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5  # fan_in = d_model
    assert abs(float(wd.std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5  # fan_in = d_ff
    assert torch.equal(params["final_norm"], torch.ones(256))
    again = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"], params["embed"])


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, scale = rng.standard_normal((2, 16, 256)), rng.standard_normal(256)
    x, scale = x.astype(np.float32), scale.astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True], ids=["(S,)", "(B,S)"])
def test_rope(batched):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 4, 64)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32) + 37
    if batched:
        pos = np.stack([pos, pos[::-1] + 5])
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_self_attention_train(granite, attn_impl):
    cfg_j, params_j, cfg_t, params_t = granite
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    # 100 tokens: two q chunks of 64 on the chunked path, the last one short.
    x = np.random.default_rng(2).standard_normal((2, 100, 256)).astype(np.float32)
    pj = jax.tree.map(lambda a: a[0], params_j["layers"]["attn"])
    pt = TT.layer(params_t["layers"], 0)["attn"]
    want, (kj, vj) = JL.self_attention_train(pj, jnp.asarray(x), cfg_j, 100, return_kv=True)
    got, (kt, vt) = TL.self_attention_train(pt, torch.from_numpy(x), cfg_t, 100,
                                            return_kv=True)
    _close(got, want)
    _close(kt, kj)
    _close(vt, vj)


@pytest.mark.parametrize("window", [100, 40])
def test_chunked_attention_gqa(window):
    """Grouped heads (8 q heads on 2 kv heads) and a sliding window, with
    a short last chunk (100 queries, chunks of 64)."""
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 100, 8, 32), (2, 100, 2, 32), (2, 100, 2, 32)))
    pos = np.arange(100)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), jnp.asarray(pos), window, True, 64)
    got = TL.chunked_attention(*map(torch.from_numpy, (q, k, v, pos, pos)), window, True, 64)
    _close(got, want, rtol=1e-5, atol=1e-5)


def _prompt(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _check_cache(got: dict, want: dict):
    assert int(got["pos"]) == int(want["pos"])
    for name in ("k", "v"):
        _close(got["self"][name], want["self"][name])
    np.testing.assert_array_equal(got["self"]["slot_pos"].numpy(),
                                  np.asarray(want["self"]["slot_pos"]))


def _prefill_then_decode(arch, attn_impl, s, max_len, steps=4):
    cfg_j, params_j, cfg_t, params_t = _pair(arch, attn_impl)
    toks = _prompt(cfg_t, 2, s, 3)
    lj, cj = JT.prefill(params_j, cfg_j, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    lt, ct = TT.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks)}, max_len=max_len)
    assert lt.shape == (2, cfg_t.padded_vocab)
    _close(lt, lj)
    _check_cache(ct, cj)
    nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(steps):
        lj, cj = JT.decode_step(params_j, cfg_j, jnp.asarray(nxt[:, None]), cj)
        lt, ct = TT.decode_step(params_t, cfg_t, torch.from_numpy(nxt[:, None]), ct)
        _close(lt, lj)
        nxt = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    _check_cache(ct, cj)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_granite_prefill_and_decode(attn_impl):
    """Full attention: the cache capacity (max_len 96) exceeds the prompt."""
    _prefill_then_decode("granite-3-2b", attn_impl, 40, 96)


def test_danube_sliding_window_ring():
    """Window 64 under a 128-token prompt: the ring keeps the last 64
    positions (cap < S), decode wraps around it, and prefill takes the
    chunked path even with flash asked for (the window is shorter than S)."""
    _prefill_then_decode("h2o-danube-1.8b", "flash", 128, 160)


@pytest.mark.parametrize("s,cap", [(12, 20), (12, 12), (12, 4)])
def test_ring_from_kv(s, cap):
    rng = np.random.default_rng(s + cap)
    ks, vs = (rng.standard_normal((3, 2, s, 2, 8)).astype(np.float32) for _ in range(2))
    want = JT._ring_from_kv(jnp.asarray(ks), jnp.asarray(vs), cap)
    got = TT._ring_from_kv(torch.from_numpy(ks), torch.from_numpy(vs), cap)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        assert got[name].is_contiguous()


@pytest.mark.parametrize("cap", [12, 4])
def test_ring_cache_from_prefill(cap):
    rng = np.random.default_rng(cap)
    k, v = (rng.standard_normal((2, 12, 2, 8)).astype(np.float32) for _ in range(2))
    want = JL.ring_cache_from_prefill(jnp.asarray(k), jnp.asarray(v), cap)
    got = TL.ring_cache_from_prefill(torch.from_numpy(k), torch.from_numpy(v), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch,seq_len", [("granite-3-2b", 48), ("h2o-danube-1.8b", 200)])
def test_init_cache_is_the_reference(arch, seq_len):
    cfg_j, cfg_t = jconfigs.get(arch).reduced(), tconfigs.get(arch).reduced()
    want = JM.init_cache(cfg_j, 3, seq_len)
    got = init_cache(cfg_t, 3, seq_len, device="cpu")
    assert int(got["pos"]) == int(want["pos"]) == 0
    for name in ("k", "v", "slot_pos"):
        g, w = got["self"][name], np.asarray(want["self"][name])
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


def test_language_model_module(granite):
    cfg_j, params_j, cfg_t, params_t = granite
    model = TT.LanguageModel(cfg_t, params_t)
    names = set(model.state_dict())
    assert {"embed", "lm_head", "final_norm", "layers.attn.wq", "layers.mlp.wd",
            "layers.ln1"} <= names and len(names) == 12
    toks = torch.from_numpy(_prompt(cfg_t, 2, 16, 5))
    got, _ = model.prefill({"tokens": toks}, max_len=32)
    want, _ = TT.prefill(params_t, cfg_t, {"tokens": toks}, max_len=32)
    assert torch.equal(got, want)
