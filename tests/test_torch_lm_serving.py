"""The port's LM ``ServingEngine`` against the JAX one, and the engine's own
behaviours (waves, budgets, EOS), mirroring tests/test_serving.py.

Reduced granite-3-2b in f32 with the JAX package's ``init_params``
carried across, on the CPU. Greedy tokens must be equal across packages:
the logits agree to about 1e-5 (tests/test_torch_models.py) and no
argmax of these requests is that close to a tie.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as JM
import repro_torch.configs as tconfigs
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(scope="module")
def setup():
    cfg_j = jconfigs.get("granite-3-2b").reduced()
    cfg_t = tconfigs.get("granite-3-2b").reduced()
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def engine(setup):
    _, _, cfg, params = setup
    return ServingEngine(cfg, params, slots=4, max_len=96, device="cpu"), cfg


def _req(uid, plen, cfg, budget=8, seed=None, cls=Request):
    rng = np.random.default_rng(seed if seed is not None else uid)
    return cls(uid=uid, prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
               max_new_tokens=budget)


def test_same_tokens_as_the_reference(setup):
    cfg_j, params_j, cfg_t, params_t = setup
    sizes = [(16, 8), (16, 5), (32, 8), (16, 8), (16, 3), (16, 8), (32, 6)]
    port = ServingEngine(cfg_t, params_t, slots=4, max_len=96, device="cpu")
    ref = JServingEngine(cfg_j, params_j, slots=4, max_len=96)
    got = port.run([_req(i, p, cfg_t, b) for i, (p, b) in enumerate(sizes)])
    want = ref.run([_req(i, p, cfg_j, b, cls=JRequest) for i, (p, b) in enumerate(sizes)])
    assert [c.uid for c in got] == [c.uid for c in want] == list(range(len(sizes)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.tokens.dtype == np.int32


def test_flash_and_chunked_serve_the_same_tokens(setup):
    _, _, cfg, params = setup
    reqs = [(i, 48) for i in range(3)]
    outs = [ServingEngine(dataclasses.replace(cfg, attn_impl=impl), params, slots=4,
                          max_len=96, device="cpu").run([_req(u, p, cfg) for u, p in reqs])
            for impl in ("chunked", "flash")]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_single_wave(engine):
    eng, cfg = engine
    outs = eng.run([_req(i, 16, cfg) for i in range(4)])
    assert [c.uid for c in outs] == [0, 1, 2, 3]
    for c in outs:
        assert c.tokens.shape == (8,)
        assert (c.tokens >= 0).all() and (c.tokens < cfg.vocab_size).all()
        assert c.prefill_s > 0 and c.decode_s > 0


def test_overflow_spills_to_second_wave(engine):
    eng, cfg = engine
    assert len(eng.run([_req(i, 16, cfg) for i in range(6)])) == 6


def test_mixed_lengths_bucketed(engine):
    eng, cfg = engine
    assert len(eng.run([_req(0, 16, cfg), _req(1, 32, cfg), _req(2, 16, cfg)])) == 3


def test_deterministic_across_wave_packing(engine):
    """A completion must not depend on its wave-mates."""
    eng, cfg = engine
    solo = eng.run([_req(0, 16, cfg, seed=42)])[0]
    packed = eng.run(
        [_req(0, 16, cfg, seed=42)] + [_req(i, 16, cfg, seed=100 + i) for i in (1, 2, 3)]
    )[0]
    np.testing.assert_array_equal(solo.tokens, packed.tokens)


def test_budget_respected(engine):
    eng, cfg = engine
    outs = eng.run([_req(0, 16, cfg, budget=3), _req(1, 16, cfg, budget=11)])
    assert outs[0].tokens.shape == (3,)
    assert outs[1].tokens.shape == (11,)


def test_too_long_rejected(engine):
    eng, cfg = engine
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(_req(0, 95, cfg, budget=8))


def test_eos_truncates(setup):
    _, _, cfg, params = setup
    base = ServingEngine(cfg, params, slots=2, max_len=64, device="cpu").run(
        [_req(0, 16, cfg, budget=8)])[0]
    eos = int(base.tokens[2])  # the token the model emits at step 2
    out = ServingEngine(cfg, params, slots=2, max_len=64, eos_id=eos, device="cpu").run(
        [_req(0, 16, cfg, budget=8)])[0]
    hit = int(np.nonzero(base.tokens == eos)[0][0])
    np.testing.assert_array_equal(out.tokens, base.tokens[:hit + 1])


def test_engine_refuses_parameters_on_another_device(setup):
    _, _, cfg, params = setup
    with pytest.raises(ValueError, match="lie on cpu"):
        ServingEngine(cfg, params, device="meta")


def test_engine_serves_only_the_dense_family(setup):
    """Every family of the zoo is served (the MoE, hybrid, media and xLSTM
    engines: tests/test_torch_moe.py, test_torch_hybrid.py,
    test_torch_media.py, test_torch_xlstm.py): an xLSTM engine serves a
    wave; a family the zoo does not have raises ``ValueError``."""
    _, _, _, params = setup
    xlstm = tconfigs.get("xlstm-1.3b").reduced()
    xparams = TT.init_params(xlstm, torch.Generator().manual_seed(0), device="cpu")
    out = ServingEngine(xlstm, xparams, slots=2, max_len=32, device="cpu").run(
        [Request(uid=0, prompt=np.arange(16, dtype=np.int32), max_new_tokens=4)])
    assert out[0].tokens.shape == (4,)
    with pytest.raises(ValueError, match="unknown model family"):
        ServingEngine(dataclasses.replace(xlstm, family="rwkv"), params, device="cpu")
    assert isinstance(params["embed"], torch.Tensor)
