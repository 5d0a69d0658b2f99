"""The port's LM training path against the JAX package, on the CPU.

Reduced granite-3-2b (2 layers, d_model 256, 4 heads, head_dim 64, d_ff
512, vocab 512, f32), with the JAX package's ``init_params`` carried
across by ``convert.lm_params_from_numpy``; the flash path runs the Pallas
forward and backward in interpret mode on the JAX side and the plain
versions through ``FlashAttention`` on the port's. Both packages get the
same batches (``synthetic_batches`` is the reference's stream bit for bit)
and, where sampling is compared, the same Bernoulli weights injected in
the batch (each package draws other bits from its own generator).

Tolerances: loss rtol 1e-5; gradients rtol 1e-4, atol 1e-5 x the leaf's
largest gradient (f32 sums in another order through two layers and the
softmax; small elements come out of cancelling sums of large ones).
After AdamW steps: losses rtol 1e-5, and parameters within atol 5e-5 for
at least 99.9% of each leaf's elements and within 2 x lr x steps for all.
Adam moves an element by lr x m_hat / sqrt(v_hat), which is lr x sign(g)
on the first step: where a gradient element lies within rounding of zero
the packages may take opposite signs, and that element (a few in 10^4
here) then differs by up to 2 lr a step while the rest agree.
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
from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import transformer as JT
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these models are small, and the suite runs files
    side by side, where each file's thread pool would contend for the
    same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(attn_impl: str = "chunked", **changes):
    cfg_j = dataclasses.replace(jconfigs.get("granite-3-2b").reduced(), attn_impl=attn_impl,
                                **changes)
    cfg_t = dataclasses.replace(tconfigs.get("granite-3-2b").reduced(), attn_impl=attn_impl,
                                **changes)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _batches(cfg_t, batch, seq, steps, seed=0):
    return [{k: v.numpy() for k, v in b.items()}
            for b in ttrain.synthetic_batches(cfg_t, batch, seq, steps, seed, "cpu")]


def _weights(b, seed):
    """Bernoulli(0.8) keep-weights keep / 0.8, as the train step draws them."""
    keep = np.random.default_rng(seed).random(b) < 0.8
    return keep.astype(np.float32) / np.float32(0.8)


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


def test_synthetic_batches_are_the_reference_stream():
    cfg_j = jconfigs.get("granite-3-2b").reduced()
    cfg_t = tconfigs.get("granite-3-2b").reduced()
    want = list(jtrain.synthetic_batches(cfg_j, 3, 24, 4, seed=5))
    got = list(ttrain.synthetic_batches(cfg_t, 3, 24, 4, seed=5, device="cpu"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


# Packed rows of 40 tokens: documents split across rows, pad tails in rows
# 0 and 2 (segment 0), and query chunks of 16 so the last one is ragged.
PACKED_SEGMENTS = np.array([[1] * 15 + [2] * 20 + [0] * 5,
                            [1] * 40,
                            [1] * 7 + [2] * 7 + [3] * 20 + [0] * 6], np.int32)


@pytest.mark.parametrize("attn_impl,kv,weighted,packed", [
    ("chunked", 4, False, False), ("chunked", 4, True, False), ("flash", 4, False, False),
    ("flash", 2, True, False), ("chunked", 4, False, True), ("flash", 2, True, True),
], ids=["chunked", "chunked-weights", "flash", "flash-gqa-weights", "chunked-packed",
        "flash-gqa-weights-packed"])
def test_forward_train_loss_and_gradients(attn_impl, kv, weighted, packed):
    """Packed rows take the chunked path under "flash" too, in both
    packages."""
    cfg_j, params_j, cfg_t, params_t = _pair(attn_impl, n_kv_heads=kv,
                                              **({"attn_chunk": 16} if packed else {}))
    batch = _batches(cfg_t, 3, 40, 1, seed=2)[0]
    if weighted:
        batch["weights"] = _weights(3, 7)
    if packed:
        batch["segments"] = PACKED_SEGMENTS
    (lj, mj), gj = jax.jit(jax.value_and_grad(JT.forward_train, has_aux=True),
                           static_argnums=1)(params_j, cfg_j,
                                             {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.requires_grad_() for _, p in _paths(params_t)]
    lt, mt = TT.forward_train(params_t, cfg_t,
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mt["ce"].detach()), float(mj["ce"]), rtol=1e-5)
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0
    for (path, _), g in zip(_paths(params_t), gt):
        w = np.asarray(_get(gj, path))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=".".join(path))


@pytest.mark.parametrize("attn_impl,policy", [
    ("chunked", "full"), ("flash", "full"), ("chunked", "dots"), ("flash", "dots"),
], ids=["chunked", "flash", "chunked-dots", "flash-dots"])
def test_remat_gives_the_same_gradients(attn_impl, policy):
    """Bitwise: "full" against no remat, "dots" against "full" (both
    recompute with the same ops in the same order; "dots" returns saved
    matmul outputs instead of recomputing them)."""
    _, _, cfg, params = _pair(attn_impl)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 2, 32, 1)[0].items()}
    leaves = [p.requires_grad_() for _, p in _paths(params)]
    grads = []
    variants = [{"remat": True}, {"remat": False}] if policy == "full" else \
        [{"remat_policy": "dots"}, {"remat_policy": "full"}]
    for changes in variants:
        loss, _ = TT.forward_train(params, dataclasses.replace(cfg, **changes), batch)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_forward_train_refuses_what_is_not_ported():
    """Packed rows on the recurrent families (hybrid, xLSTM) raise as in
    the reference, and a family the zoo does not have raises ``ValueError``;
    an xLSTM model trains. ("dots" and dense packed rows train: the tests
    above; the MoE family: tests/test_torch_moe.py; the VLM and audio
    families: tests/test_torch_media.py; xLSTM against the reference:
    tests/test_torch_xlstm.py.)"""
    _, _, cfg, params = _pair()
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1, 8, 1)[0].items()}
    xlstm = tconfigs.get("xlstm-1.3b").reduced()
    xparams = TT.init_params(xlstm, torch.Generator().manual_seed(0), device="cpu")
    loss, metrics = TT.forward_train(xparams, xlstm, batch)
    assert torch.isfinite(loss) and float(metrics["aux"]) == 0.0
    for arch, p in (("zamba2-1.2b", params), ("xlstm-1.3b", xparams)):
        with pytest.raises(ValueError, match="per-segment state resets"):
            TT.forward_train(p, tconfigs.get(arch).reduced(),
                             {**batch, "segments": batch["tokens"]})
    with pytest.raises(ValueError, match="unknown model family"):
        TT.forward_train(params, dataclasses.replace(cfg, family="rwkv"), batch)


def _recipe(O, lr, steps):
    return O.adamw(O.cosine_schedule(lr, max(steps // 20, 1), steps), weight_decay=0.01,
                   max_grad_norm=1.0)


def _train_both(cfg_j, params_j, cfg_t, params_t, make_opt, batches, accum=1):
    """The same steps through both packages' ``make_train_step``; returns the
    losses and final parameters of each."""
    jopt, topt = make_opt(JO), make_opt(TO)
    jstep = jax.jit(j_make_train_step(cfg_j, jopt, accum=accum))
    tstep = make_train_step(cfg_t, topt, accum=accum)
    sj, st = jopt.init(params_j), topt.init(params_t)
    lj, lt = [], []
    for i, b in enumerate(batches):
        params_j, sj, mj = jstep(params_j, sj, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.PRNGKey(i))
        params_t, st, mt = tstep(params_t, st, {k: torch.from_numpy(v) for k, v in b.items()},
                                 torch.Generator().manual_seed(i))
        lj.append(float(mj["loss"]))
        lt.append(float(mt["loss"]))
    return lj, lt, params_j, params_t


def _same_params(params_t, params_j, lr: float, steps: int, atol=5e-5):
    for path, p in _paths(params_t):
        diff = np.abs(p.detach().numpy() - np.asarray(_get(params_j, path)))
        name = ".".join(path)
        assert (diff > atol).mean() <= 1e-3, f"{name}: {(diff > atol).sum()} elements off"
        assert diff.max() <= 2 * lr * steps, f"{name}: max |diff| {diff.max()}"


PACKED_SEGMENTS_4x32 = np.array([[1] * 10 + [2] * 16 + [0] * 6, [1] * 32,
                                 [1] * 20 + [0] * 12, [1] * 5 + [2] * 5 + [3] * 22], np.int32)


@pytest.mark.parametrize("accum,packed", [(1, False), (2, False), (2, True)],
                         ids=["1", "2", "2-packed"])
def test_train_step_matches_reference(accum, packed):
    """Three steps of the AdamW recipe, Bernoulli weights injected; packed,
    the segments split into microbatches beside the tokens and weights."""
    cfg_j, params_j, cfg_t, params_t = _pair()
    batches = _batches(cfg_t, 4, 32, 3, seed=1)
    for i, b in enumerate(batches):
        b["weights"] = _weights(4, 10 + i)
        if packed:
            b["segments"] = np.roll(PACKED_SEGMENTS_4x32, i, axis=0)
    lj, lt, pj, pt = _train_both(cfg_j, params_j, cfg_t, params_t,
                                 lambda O: _recipe(O, 5e-3, 3), batches, accum)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    _same_params(pt, pj, 5e-3, 3)


def test_sampled_train_step_is_reproducible():
    """sampling_rate 0.8: the weights come from the generator, so one seed
    gives the same run twice, and another seed another run."""
    _, _, cfg, params0 = _pair()
    batches = _batches(cfg, 4, 16, 3, seed=3)
    runs = []
    for seed in (0, 0, 1):
        params = TT.map_schema(lambda path, e: _get(params0, path).detach().clone(),
                               TT.param_schema(cfg))
        opt = _recipe(TO, 5e-3, 3)
        step = make_train_step(cfg, opt, accum=2, sampling_rate=0.8)
        state, gen = opt.init(params), torch.Generator().manual_seed(seed)
        losses = []
        for b in batches:
            batch = {k: torch.from_numpy(v) for k, v in b.items()}
            params, state, m = step(params, state, batch, gen)
            losses.append(float(m["loss"]))
        runs.append((losses, [p.detach().clone() for _, p in _paths(params)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0] != runs[2][0]


@pytest.mark.parametrize("regime", ["fresh", "stale", "stale+prop1"])
def test_example_regimes_match_reference(regime):
    """examples/train_lm_delayed_gradient.py's three optimizer regimes
    (tau = 4, lr 3e-3, rho 0.3), six steps, weights injected."""
    tau, lr = 4, 3e-3
    if regime == "stale+prop1":
        lr *= JO.staleness_step_scale(tau, 0.3)

    def make(O):
        opt = O.adamw(lr, max_grad_norm=1.0)
        return opt if regime == "fresh" else O.delayed_gradient(opt, tau)

    cfg_j, params_j, cfg_t, params_t = _pair()
    batches = _batches(cfg_t, 4, 32, 6, seed=0)
    for i, b in enumerate(batches):
        b["weights"] = _weights(4, 20 + i)
    lj, lt, pj, pt = _train_both(cfg_j, params_j, cfg_t, params_t, make, batches)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    _same_params(pt, pj, lr, 6)


def test_train_driver_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--log-every", "1", "--delay", "1", "--sample", "0.8"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "step     3" in out.stdout


def test_train_driver_refuses_gbdt():
    """``--arch gbdt`` trains (tests/test_torch_gbdt_driver.py), threaded
    too (tests/test_torch_async.py), and sharded (tests/test_torch_mesh.py);
    what the train CLI refuses is the sharded build under the threaded
    runtime, with the reference's message."""
    with pytest.raises(SystemExit, match="threaded runtime builds on the local device"):
        ttrain.main(["--arch", "gbdt", "--device", "cpu", "--runtime", "threads",
                     "--mesh", "1d"])
