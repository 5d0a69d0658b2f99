"""The port's sharded LM step over a (data, model) mesh, on the CPU.

Four gloo rank processes on a (2, 2) ``("data", "model")`` mesh, and for
a few cases a (4, 1) one (``launch.mesh.make_lm_mesh``; the program is
tests/_torch_lm_mesh_ranks.py, which holds the cases), started once by a
module-scoped fixture, run every sharded case; meanwhile this process runs
the single-device counterparts and the JAX package. Reduced granite-3-2b,
phi3.5-moe-42b (4 experts, top-2) and xlstm-1.3b in f32, seeded torch
weights (the same in every process), batches of 8 x 32 tokens from numpy
seeds, one torch thread a process.

Standards:

  * ``named`` / ``tree_shardings``: every rank's shards reassemble bit for
    bit and rank 0's blocks are the spec's; ``collectives.gather`` (both
    forms) equals the whole, ``psum_scatter`` the block of the sum;
  * ``moe_ffn``'s mesh branch against the JAX package's shard_map body
    emulated on one device (``_router`` and ``_expert_block`` for each
    (data shard, model shard) with its ``e_offset`` and the shard's
    capacity, summed over the model shards; aux the mean over the data
    shards), on the training route and on the decode route that cuts d_ff
    over 'data': 1e-5;
  * the sharded ``make_train_step`` against the port's single-device
    step. On the MoE model the sharded step routes each data shard's
    tokens with its own capacity and averages the shards' router losses,
    as the reference's does, so its single-device twin is the step that
    takes the data shards as microbatches (accum x the data ranks), which
    computes the same function (the sampled case sets the router loss weight to 0
    instead, since a weighted mean does not split so). One step of plain
    SGD at lr 1 leaves the weights less the gradients: every element
    within 1e-5 (the router loss weighted 1 on the MoE model, so that a
    router gradient summed twice would show), on the (2, 2) mesh and on
    the (4, 1) one, where one rank holds every expert but the batch is
    cut four ways. Two steps of
    ``adamw(1e-3, max_grad_norm=1.0)`` (accum 1 and 2, sampling 0.5),
    capacity factor 4 on the MoE model (no token drops): losses rtol
    1e-5, 99.99% of each leaf within 1e-5 and every element within 2 x lr
    x steps (Adam's first step is lr x sign(g): an element whose gradient
    lies within rounding of zero may move the other way). The MoE model
    at the default capacity against the plain single-device step: the
    reference's 5e-2 on loss and parameters (tests/test_distributed.py);
  * one sharded step against the JAX package's single-device
    ``make_train_step`` on the same numpy weights (the MoE model's
    against its accum 2 twin, ce compared): tests/test_torch_lm_train.py's
    standard (loss rtol 1e-5; 99.9% of each leaf within 5e-5, all within
    2 x lr);
  * the bytes on 'model': no expert weight, the MoE activations' psums;
  * sharded decode under ``serving_rules`` placement gives the
    single-device tokens and logits within 1e-5, granite and
    phi3.5-moe, and phi3.5-moe on the (4, 1) mesh (its decode cuts d_ff
    over 'data' with one expert shard); the host mesh serves bitwise as
    no mesh.
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

import _torch_lm_mesh_ranks as R
import repro.configs as jconfigs
import repro.optim as JO
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import layers as JL
from repro_torch import collectives
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import free_port, make_host_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.serving import Request, ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The single-device twin of a sharded MoE case takes the data shards as
# microbatches (see the module's docstring).
TWIN_ACCUM = {"phi-a1": 2, "phi-a2": 4, "phi-sgd": 2, "phi-sgd-4x1": 4}


def _single(name: str) -> tuple[list, list]:
    """The port's single-device run of a case: (loss, ce) a step, and the
    parameters after the first and the last step."""
    arch, accum, rate, changes, optname, steps = R.CASES[name]
    cfg, opt = R.cfg_of(arch, changes), R.optimizer(optname)
    params = R.weights(cfg)
    state = opt.init(params)
    step = make_train_step(cfg, opt, accum=TWIN_ACCUM.get(name, accum), sampling_rate=rate)
    gen, losses, first = torch.Generator().manual_seed(5), [], None
    for b in R.batches(cfg, steps):
        params, state, m = step(params, state, b, gen)
        losses.append((float(m["loss"]), float(m["ce"])))
        first = first or [p.detach().clone().numpy() for p in R.flat(params)]
    return losses, first, [p.detach().numpy() for p in R.flat(params)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks, and meanwhile every single-device run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("lm_mesh") / "ranks.pt"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "WORLD_SIZE": "4", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    ranks = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_lm_mesh_ranks.py"),
                               str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT, env={**env, "RANK": str(r)})
             for r in range(4)]
    try:
        single = {name: _single(name) for name in R.CASES}
        moe = {route: _moe_reference(route) for route in ("train", "decode")}
        anchors = {name: _jax_step(name) for name in JAX_ANCHORS}
    finally:
        for r, proc in enumerate(ranks):
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"rank {r}: {err[-3000:]}"
        torch.set_num_threads(before)
    return {"ranks": torch.load(out, weights_only=False), "single": single, "moe": moe,
            "jax": anchors}


# ------------------------------------------------------------- placements
# Rank 0 sits at (data 0, model 0): each spec's first block of an 8 x 12.
FIRST_BLOCKS = {"a": np.s_[0:4, 0:6], "b": np.s_[0:2], "c": np.s_[:, 0:3], "d": np.s_[0:4],
                "e": np.s_[:]}


@pytest.mark.parametrize("name", sorted(FIRST_BLOCKS))
def test_named_shards_reassemble(run, name):
    """Every rank's block gathers back to the whole bit for bit; rank 0's
    block is the spec's first (a tuple entry major first)."""
    full = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    assert run["ranks"]["named"][name]
    np.testing.assert_array_equal(run["ranks"]["named_blocks"][name], full[FIRST_BLOCKS[name]])


@pytest.mark.parametrize("form", ["all_gather", "psum", "psum_scatter"])
def test_gather_and_reduce_scatter(run, form):
    """``gather`` by ``all_gather`` and by the byte-summed psum of a
    zero-filled whole equal ``torch.cat`` of the blocks; ``psum_scatter``
    is the block of the sum."""
    r = run["ranks"]
    assert r["psum_scatter"] if form == "psum_scatter" else r["gather"][form == "psum"]


def test_host_mesh_is_the_reference_ones():
    """``make_host_mesh`` is the 1 x 1 ("data", "model") mesh, with no
    process group in this process: its collectives return their input."""
    mesh = make_host_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    assert not torch.distributed.is_initialized()
    x = torch.arange(4.0)
    for a in mesh.axes:
        assert collectives.psum(x, a) is x and collectives.gather(x, a, 0) is x


# -------------------------------------------------------------- moe_ffn
def _moe_reference(route: str):
    """The reference's shard_map body on one device: each (data, model)
    shard's router and expert block, summed over the shards that split the
    output."""
    cfg = dataclasses.replace(jconfigs.get(R.ARCHS["phi"]).reduced())
    tcfg = R.cfg_of("phi", {})
    moe = {k: jnp.array(v[0].numpy()) for k, v in R.weights(tcfg)["layers"]["moe"].items()}
    x = jnp.asarray(R.moe_inputs())
    e_loc, ff_loc = cfg.n_experts // 2, cfg.d_ff // 2
    outs, auxes = [], []
    rows = (x[0:2], x[2:4]) if route == "train" else (x,)
    for xb in rows:
        xf = xb.reshape(-1, cfg.d_model)
        weights, ids, aux = JL._router(moe, xf, cfg)
        t = xf.shape[0]
        cap = max(1, int(cfg.top_k * t / cfg.n_experts * cfg.capacity_factor)) \
            if route == "train" else t
        out = jnp.zeros_like(xf)
        for m in range(2):
            ex = slice(m * e_loc, (m + 1) * e_loc)
            ffs = (slice(None),) if route == "train" else (slice(0, ff_loc),
                                                           slice(ff_loc, None))
            for ff in ffs:
                out = out + JL._expert_block(xf, ids, weights, moe["wg"][ex][:, :, ff],
                                             moe["wu"][ex][:, :, ff], moe["wd"][ex][:, ff, :],
                                             m * e_loc, cap)
        outs.append(out.reshape(xb.shape))
        auxes.append(aux)
    return np.concatenate([np.asarray(o) for o in outs]), float(np.mean(auxes))


@pytest.mark.parametrize("route", ["train", "decode"])
def test_moe_mesh_branch_matches_the_reference_body(run, route):
    """Layer 0 of reduced phi3.5-moe on the (2, 2) mesh: 2 rows a data
    shard with its own capacity (train) or every token at full capacity
    with d_ff cut over 'data' (decode), against the reference's body."""
    got, aux = run["ranks"][f"moe_{route}"]
    want, want_aux = run["moe"][route]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert abs(aux - want_aux) <= 1e-5


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("name", list(R.CASES))
def test_sharded_step_matches_single_device(run, name):
    arch, accum, rate, changes, optname, steps = R.CASES[name]
    got = run["ranks"]["train"][name]
    losses, _, want = run["single"][name]
    params = [p.numpy() for p in R.flat(got["params"])]
    if name == "phi-default":
        assert max(abs(a[0] - b[0]) for a, b in zip(got["losses"], losses)) < 5e-2
        assert max(np.abs(a - b).max() for a, b in zip(params, want)) < 5e-2
        return
    col = 1 if name in TWIN_ACCUM else 0  # an accum > 1 step reports ce alone
    np.testing.assert_allclose([x[col] for x in got["losses"]], [x[col] for x in losses],
                               rtol=1e-5)
    for a, b in zip(params, want):
        diff = np.abs(a - b)
        if optname == "sgd":
            assert diff.max() <= 1e-5
        else:
            assert (diff > 1e-5).mean() <= 1e-4 and diff.max() <= 2 * R.LR * steps


def test_replicas_and_ranks_agree(run):
    """Every rank that holds a block of a parameter or moment holds the
    same bits as the other holders; every rank gathers the same
    parameters."""
    assert all(ok for _, ok in run["ranks"]["replicas_agree"])
    assert run["ranks"]["ranks_agree"]


JAX_ANCHORS = ("granite-a1", "phi-a1")


def _jax_step(name: str) -> tuple:
    """The JAX package's single-device ``make_train_step``, one AdamW step of
    a case on its weights and first batch: (loss, parameters)."""
    arch, _, _, changes, _, _ = R.CASES[name]
    cfg = R.cfg_of(arch, changes)
    cfg_j = dataclasses.replace(jconfigs.get(R.ARCHS[arch]).reduced(), **changes)
    # jnp.array copies: jnp.asarray could alias the torch tensors' memory
    params = jax.tree.map(lambda t: jnp.array(t.numpy()), R.weights(cfg))
    opt = JO.adamw(R.LR, max_grad_norm=1.0)
    batch = {k: jnp.array(v.numpy()) for k, v in R.batches(cfg, 1)[0].items()}
    step = jax.jit(j_make_train_step(cfg_j, opt, accum=TWIN_ACCUM.get(name, 1)))
    pj, _, mj = step(params, opt.init(params), batch, jax.random.PRNGKey(0))
    return float(mj["loss"]), dict(_paths(jax.tree.map(np.asarray, pj)))


@pytest.mark.parametrize("name", JAX_ANCHORS)
def test_sharded_step_matches_the_jax_package(run, name):
    """One sharded AdamW step against the JAX package's single-device
    ``make_train_step`` on the same numpy weights and batch."""
    loss, want = run["jax"][name]
    got = run["ranks"]["train"][name]
    np.testing.assert_allclose(got["losses"][0][1 if name in TWIN_ACCUM else 0], loss,
                               rtol=1e-5)
    for path, a in _paths(got["first"]):
        diff = np.abs(a.numpy() - want[path])
        assert (diff > 5e-5).mean() <= 1e-3 and diff.max() <= 2 * R.LR


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_no_expert_weight_crosses_the_model_axis(run):
    """On 'model' a step moves the dense weights' gathers, the MoE
    activations' psums (the output forward, its input's gradient back),
    the combine weights' gradient and the norm: never an expert weight
    nor a gradient. The activations: one psum a layer each way of the
    shard's 4 x 32 x 256 f32 tokens."""
    cfg = R.cfg_of("phi", {})
    got = run["ranks"]["train"]["phi-a1"]["model_bytes"]
    tags = {t for _, t in got}
    assert not [t for t in tags if t.startswith("grad:") or
                any(t == f"param:layers.moe.{w}" for w in ("wg", "wu", "wd"))]
    steps, tokens = R.CASES["phi-a1"][5], 4 * R.S
    for tag in ("moe.out", "moe.x.grad"):
        assert got[("psum", tag)] == steps * cfg.n_layers * tokens * cfg.d_model * 4
    assert got[("psum", "moe.weights.grad")] == steps * cfg.n_layers * tokens * cfg.top_k * 4


# ---------------------------------------------------------------- serving
def _decode_single(cfg):
    params = R.weights(cfg)
    tok, logits, cache = make_prefill_step(cfg, max_len=R.DECODE_P + R.DECODE_GEN)(
        params, {"tokens": R.prompts(cfg)})
    toks = [tok]
    for _ in range(R.DECODE_GEN - 1):
        tok, cache = make_decode_step(cfg)(params, toks[-1][:, None], cache)
        toks.append(tok)
    return torch.stack(toks, 1).numpy(), logits.numpy()


@pytest.mark.parametrize("name", list(R.DECODE))
def test_sharded_decode_matches_single_device(run, name):
    """Prefill (rows cut over 'data') and decode (every row on every rank,
    the MoE's d_ff cut over 'data') under ``serving_rules`` placement."""
    tokens, logits = _decode_single(R.cfg_of(*R.DECODE[name]))
    got = run["ranks"]["decode"][name]
    np.testing.assert_array_equal(got["tokens"], tokens)
    np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["granite", "phi"])
def test_engine_on_the_host_mesh_is_bitwise_no_mesh(arch):
    cfg = R.cfg_of(arch, {})
    prompts = R.prompts(cfg).numpy()
    answers = []
    for mesh in (None, make_host_mesh(device="cpu")):
        engine = ServingEngine(cfg, R.weights(cfg), slots=2, max_len=32, device="cpu",
                               mesh=mesh)
        done = engine.run([Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)])
        answers.append([c.tokens for c in done])
    assert all(np.array_equal(a, b) for a, b in zip(*answers))


def test_serve_cli_tokens_are_unchanged_on_the_host_mesh():
    """The LM serve CLI runs on ``make_host_mesh()``; its tokens are the
    unmeshed steps' on the same seeded weights and prompts."""
    got = tserve.main(["--arch", "phi3.5-moe-42b", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "16", "--gen", "4"])
    cfg = R.tconfigs.get("phi3.5-moe-42b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = R.init_params(cfg, gen, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, dtype=torch.int32)
    tok, _, cache = make_prefill_step(cfg, max_len=20)(params, {"tokens": prompts})
    want = [tok]
    for _ in range(3):
        tok, cache = make_decode_step(cfg)(params, want[-1][:, None], cache)
        want.append(tok)
    np.testing.assert_array_equal(got, torch.stack(want, 1).numpy())


def test_sharded_serving_steps_refuse_inference_tensors():
    """The mesh steps memoise the gathered parameters by version counter;
    shards made under ``torch.inference_mode`` keep none and are refused
    rather than gathered again at every call."""
    cfg = R.cfg_of("granite", {})
    with torch.inference_mode():
        params = R.weights(cfg)
    step = make_prefill_step(cfg, make_host_mesh(device="cpu"), ("data",), max_len=20)
    with pytest.raises(ValueError, match="inference tensors"):
        step(params, {"tokens": R.prompts(cfg)})
