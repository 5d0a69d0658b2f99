"""The rank program of tests/test_torch_lm_mesh.py, and the cases it shares
with the test: one process a rank of a (2, 2) ``("data", "model")`` mesh
(and, for the cases in ``MESH``, a (4, 1) one) over gloo on the CPU, joined from a torchrun-style environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT). Rank 0 writes what every case gave
to the path in ``argv[1]``. Imports torch and the port only.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        PYTHONPATH=src python tests/_torch_lm_mesh_ranks.py out.pt
"""
import dataclasses
import hashlib
import sys

import numpy as np
import torch

import repro_torch.configs as tconfigs
import repro_torch.optim as TO
from repro_torch import collectives
from repro_torch.models import init_params

B, S, LR = 8, 32, 1e-3
ARCHS = {"granite": "granite-3-2b", "phi": "phi3.5-moe-42b", "xlstm": "xlstm-1.3b"}
NO_DROP = {"capacity_factor": 4.0}  # capacity = 2T >= T: no token drops
NO_AUX = {**NO_DROP, "router_aux_weight": 0.0}
AUX = {**NO_DROP, "router_aux_weight": 1.0}
# name -> (arch, accum, sampling rate, config changes, optimizer, steps). The
# "sgd" cases take one step of plain SGD at lr 1: their parameters are the
# weights less the gradients.
CASES = {
    "granite-a1": ("granite", 1, 0.0, {}, "adamw", 2),
    "granite-a2": ("granite", 2, 0.0, {}, "adamw", 2),
    "granite-s": ("granite", 1, 0.5, {}, "adamw", 2),
    "granite-sgd": ("granite", 1, 0.0, {}, "sgd", 1),
    "phi-a1": ("phi", 1, 0.0, NO_DROP, "adamw", 2),
    "phi-a2": ("phi", 2, 0.0, NO_DROP, "adamw", 2),
    "phi-s": ("phi", 1, 0.5, NO_AUX, "adamw", 2),
    "phi-sgd": ("phi", 1, 0.0, AUX, "sgd", 1),
    "phi-sgd-4x1": ("phi", 1, 0.0, AUX, "sgd", 1),
    "phi-default": ("phi", 1, 0.0, {}, "adamw", 2),
    "xlstm-a1": ("xlstm", 1, 0.0, {}, "adamw", 2),
    "xlstm-a2": ("xlstm", 2, 0.0, {}, "adamw", 1),
    "xlstm-s": ("xlstm", 1, 0.5, {}, "adamw", 1),
    "xlstm-sgd": ("xlstm", 1, 0.0, {}, "sgd", 1),
}
# The (data, model) mesh of a case, where it is not (2, 2): the batch cut
# four ways with one expert shard.
MESH = {"phi-sgd-4x1": (4, 1), "phi-4x1": (4, 1)}
# name -> (arch, config changes) of a decode case
DECODE = {"granite": ("granite", {}), "phi": ("phi", NO_DROP), "phi-4x1": ("phi", NO_DROP)}
DECODE_B, DECODE_P, DECODE_GEN = 4, 16, 5


def cfg_of(arch: str, changes: dict):
    return dataclasses.replace(tconfigs.get(ARCHS[arch]).reduced(), **changes)


def weights(cfg) -> dict:
    return init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def batches(cfg, steps: int, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(toks[:, :S]),
                    "labels": torch.from_numpy(toks[:, 1:])})
    return out


def optimizer(name: str):
    return TO.adamw(LR, max_grad_norm=1.0) if name == "adamw" else TO.sgd(1.0)


def prompts(cfg) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (DECODE_B, DECODE_P)).astype(np.int32))


def moe_inputs() -> np.ndarray:
    return np.random.default_rng(3).standard_normal((4, S, 256)).astype(np.float32)


def flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flat(v)]
    return [tree]


def main(out_path: str) -> None:
    from repro_torch.launch.mesh import init_from_env, make_lm_mesh
    from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                          make_train_step, working_specs)
    from repro_torch.models import layers as L
    from repro_torch.sharding import (block, map_specs, named, optimizer_state_specs,
                                      param_specs, serving_rules, tree_shardings)
    from repro_torch.sharding.rules import P, entry_axes

    torch.set_num_threads(1)
    rank, world, _ = init_from_env("cpu")
    meshes = {shape: make_lm_mesh(*shape, device="cpu") for shape in ((2, 2), (4, 1))}
    mesh = meshes[2, 2]
    data, model = mesh.axis("data"), mesh.axis("model")
    out: dict = {}

    def replicas_agree(mesh, spec, x) -> bool:
        """Every rank that holds the same block of x holds the same bits."""
        ok = True
        for a in mesh.axes:
            if a.size > 1 and all(a.name not in entry_axes(spec, d) for d in range(len(spec))):
                every = collectives.gather(x[None], a, 0)
                ok &= all(torch.equal(every[i], x) for i in range(a.size))
        return ok

    # named / tree_shardings, gather in both forms, psum_scatter
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    specs = {"a": P("data", "model"), "b": P(("data", "model")),
             "c": P(None, ("model", "data")), "d": P("model"), "e": P()}
    placed = tree_shardings(mesh, specs)
    out["named"] = {k: torch.equal(pl.gather(pl.shard(full)), full)
                    for k, pl in placed.items()}
    out["named_blocks"] = {k: pl.shard(full).numpy() for k, pl in placed.items()}
    mine = block(full, 1, data)
    out["gather"] = {f: torch.equal(collectives.gather(mine, data, 1, by_psum=f), full)
                     for f in (False, True)}
    parts = [torch.arange(12.).reshape(4, 3) * (r + 1) for r in range(world)]
    got = collectives.psum_scatter(parts[rank], data, 0)
    want = parts[model.index] + parts[2 + model.index]
    out["psum_scatter"] = torch.equal(got, block(want, 0, data))

    # moe_ffn's mesh branch, layer 0 of reduced phi3.5-moe, on both routes
    cfg = cfg_of("phi", {})
    moe = {k: v[0] for k, v in weights(cfg)["layers"]["moe"].items()}
    x = torch.from_numpy(moe_inputs())
    for route, axes in (("train", ("data",)), ("decode", ())):
        work = working_specs(cfg, mesh, axes)["layers"]["moe"]
        p = {k: named(mesh, P(*work[k][1:])).shard(v) for k, v in moe.items()}
        y, aux = L.moe_ffn(p, block(x, 0, data) if axes else x, cfg, mesh, axes,
                           capacity=None if axes else -1)
        out[f"moe_{route}"] = ((collectives.gather(y, data, 0) if axes else y).numpy(),
                               float(aux))

    # the sharded train step, every case
    out["train"], out["replicas_agree"] = {}, []
    for name, (arch, accum, rate, changes, optname, steps) in CASES.items():
        mesh = meshes[MESH.get(name, (2, 2))]
        cfg = cfg_of(arch, changes)
        opt = optimizer(optname)
        specs = param_specs(cfg, mesh)
        placed = tree_shardings(mesh, specs)
        shards = map_specs(lambda pl, w: pl.shard(w), placed, weights(cfg))
        state = opt.init(shards)
        step = make_train_step(cfg, opt, mesh, ("data",), accum=accum, sampling_rate=rate,
                               grad_specs=specs)
        gen = torch.Generator().manual_seed(5)
        losses, rec, first = [], collectives.ByteRecorder(), None
        for b in batches(cfg, steps):
            with collectives.recording(rec):
                shards, state, m = step(shards, state, b, gen)
            losses.append((float(m["loss"]), float(m["ce"])))
            first = first or map_specs(lambda pl, w: pl.gather(w).detach().clone(), placed,
                                       shards)
        agree = []
        map_specs(lambda s, w: agree.append(replicas_agree(mesh, s, w)), specs, shards)
        map_specs(lambda s, w: agree.append(replicas_agree(mesh, s, w)),
                  optimizer_state_specs(state, specs), state)
        out["replicas_agree"].append((name, all(agree)))
        out["train"][name] = {
            "losses": losses, "first": first,
            "params": map_specs(lambda pl, w: pl.gather(w).detach().clone(), placed, shards),
            "model_bytes": rec.by_tag("model"),
        }

    # decode under serving placement
    out["decode"] = {}
    for name, (arch, changes) in DECODE.items():
        mesh = meshes[MESH.get(name, (2, 2))]
        cfg = cfg_of(arch, changes)
        specs = param_specs(cfg, mesh, serving_rules())
        shards = map_specs(lambda s, w: named(mesh, s).shard(w), specs, weights(cfg))
        prefill = make_prefill_step(cfg, mesh, ("data",), DECODE_P + DECODE_GEN, specs=specs)
        decode = make_decode_step(cfg, mesh, ("data",), specs=specs)
        tok, logits, cache = prefill(shards, {"tokens": prompts(cfg)})
        toks = [tok]
        for _ in range(DECODE_GEN - 1):
            tok, cache = decode(shards, toks[-1][:, None], cache)
            toks.append(tok)
        out["decode"][name] = {"tokens": torch.stack(toks, 1).numpy(),
                               "logits": logits.numpy()}

    every = [None] * world
    digest = hashlib.sha256()
    for n in CASES:
        for x in flat(out["train"][n]["params"]):
            digest.update(x.numpy().tobytes())
    torch.distributed.all_gather_object(every, digest.hexdigest())
    out["ranks_agree"] = len(set(every)) == 1
    if rank == 0:
        torch.save(out, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
