"""The port's GBDT configuration, serial helpers and CLIs against the JAX
package's.

``configs.gbdt``: every experiment's fields (``quick`` too) and its data
(bins, edges, labels, multiplicities) equal the reference's;
``train_serial`` is the engine under ``("round_robin", 1)``, bit for bit;
the trainer cache is an LRU of 8; ``gbdt_dataset_for`` builds the
reference's workloads for every objective (query ids too);
``efficiency-e2006`` resolves its squared-error objective and trains;
``launch.train.main`` and ``launch.serve.main`` (both engines, int8; the
regression and ranking objectives) run on the CPU, the loss falling and
the swap happening.
"""
import numpy as np
import pytest
import torch

import repro.configs.gbdt as jgbdt
from repro.launch import train as jtrain
import repro_torch.configs.gbdt as tgbdt
from repro_torch.core.sgbdt import init_state, train_loss, train_serial
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.ps import engine as tengine
from repro_torch.ps import Trainer
from repro_torch.trees.binning import bin_dataset

SGBDT_FIELDS = ("n_trees", "step_length", "sampling_rate", "loss", "objective")
LEARNER_FIELDS = ("depth", "n_bins", "lam", "min_child_hess", "feature_fraction",
                  "hist_mode")


def _same_config(t, j) -> None:
    for name in SGBDT_FIELDS:
        assert getattr(t, name) == getattr(j, name), name
    for name in LEARNER_FIELDS:
        assert getattr(t.learner, name) == getattr(j.learner, name), name


def test_experiments_equal_the_reference():
    assert list(tgbdt.EXPERIMENTS) == list(jgbdt.EXPERIMENTS)
    for name, t in tgbdt.EXPERIMENTS.items():
        j = jgbdt.EXPERIMENTS[name]
        assert (t.name, t.paper_section) == (j.name, j.paper_section)
        assert vars(t.dataset) == vars(j.dataset)
        _same_config(t.config, j.config)


@pytest.mark.parametrize("name", list(jgbdt.EXPERIMENTS))
def test_get_equals_the_reference(name, monkeypatch):
    """The config, plain and quick, and the dataset bit for bit."""
    for quick in (False, True):
        with monkeypatch.context() as m:  # configs alone: the dataset spec, not its data
            m.setattr(tgbdt, "load", lambda spec, device=None: spec)
            m.setattr(jgbdt, "load", lambda spec: spec)
            (tcfg, tspec), (jcfg, jspec) = tgbdt.get(name, quick), jgbdt.get(name, quick)
        _same_config(tcfg, jcfg)
        assert vars(tspec) == vars(jspec)
    assert tcfg.n_trees == max(jgbdt.EXPERIMENTS[name].config.n_trees // 5, 40)
    _, tdata = tgbdt.get(name, device="cpu")
    _, jdata = jgbdt.get(name)
    for field in ("bins", "bin_edges", "labels", "multiplicity"):
        np.testing.assert_array_equal(getattr(tdata, field).numpy(),
                                      np.asarray(getattr(jdata, field)), err_msg=field)
    assert tdata.n_bins == jdata.n_bins


def test_e2006_resolves_its_objective_and_trains():
    cfg, data = tgbdt.get("efficiency-e2006", device="cpu")
    assert cfg.loss == "mse" and data.bins.shape == (3000, 2000)
    assert cfg.obj.name == "mse" and cfg.obj.n_outputs == 1
    # Two rounds at depth 3 on a row subset: the CPU runs the plain kernels.
    small = cfg._replace(n_trees=2, learner=cfg.learner._replace(depth=3))
    rows = data._replace(bins=data.bins[:500], labels=data.labels[:500],
                         multiplicity=data.multiplicity[:500])
    state = Trainer(small, device="cpu").train(rows, ("round_robin", 2), seed=0)
    assert int(state.forest.n_trees) == 2 and torch.isfinite(state.f).all()
    assert float(train_loss(small, rows, state)) < float(
        train_loss(small, rows, init_state(small, rows)))


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 10)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 3] > 0).astype(np.float32)
    data = bin_dataset(x, y, n_bins=64, device="cpu")
    cfg = tgbdt.EXPERIMENTS["validity-higgs"].config._replace(n_trees=5)
    return cfg._replace(learner=cfg.learner._replace(depth=3)), data


def test_train_serial_is_the_engine_under_round_robin_1(small):
    cfg, data = small
    seen = []
    got = train_serial(cfg, data, seed=3, eval_every=2, eval_fn=lambda st, j: seen.append(j))
    want = Trainer(cfg, device="cpu").train(data, ("round_robin", 1), seed=3)
    assert seen == [2, 4] and got.step == want.step == cfg.n_trees
    for name in ("feature", "threshold", "leaf_value", "n_trees", "base_score"):
        assert torch.equal(getattr(got.forest, name), getattr(want.forest, name)), name
    assert torch.equal(got.f, want.f)


def test_trainer_cache_is_an_lru_of_eight(small):
    cfg, data = small
    tengine.clear_trainers()
    first = tengine.get_trainer(cfg, "cpu")
    assert tengine.get_trainer(cfg, "cpu") is first and first.device.type == "cpu"
    assert tengine.get_trainer(cfg, "meta") is not first  # the key holds the device
    cfgs = [cfg._replace(n_trees=k) for k in range(10, 16)]
    for c in cfgs:
        tengine.get_trainer(c, "cpu")
    assert len(tengine._TRAINERS) == 8
    tengine.get_trainer(cfg, "cpu")  # touched: now the newest
    tengine.get_trainer(cfg._replace(n_trees=99), "cpu")
    assert tengine.get_trainer(cfg, "cpu") is first  # survived by recency
    assert (cfg, torch.device("meta")) not in tengine._TRAINERS  # the oldest went
    tengine.clear_trainers()
    assert not tengine._TRAINERS and tengine.get_trainer(cfg, "cpu") is not first
    tengine.clear_trainers()


@pytest.mark.parametrize("objective", ["logistic", "multiclass:3", "mse", "lambdarank",
                                       "quantile:0.9", "huber"])
def test_gbdt_dataset_for_equals_the_reference(objective):
    tobj, tdata = ttrain.gbdt_dataset_for(objective, 4, n=600, device="cpu")
    jobj, jdata = jtrain.gbdt_dataset_for(objective, 4, n=600)
    assert (tobj.name, tobj.n_outputs) == (jobj.name, jobj.n_outputs)
    for field in ("bins", "bin_edges", "labels", "multiplicity"):
        np.testing.assert_array_equal(getattr(tdata, field).numpy(),
                                      np.asarray(getattr(jdata, field)), err_msg=field)
    assert (tdata.qid is None) == (jdata.qid is None) == (objective != "lambdarank")
    if jdata.qid is not None:
        np.testing.assert_array_equal(tdata.qid.numpy(), np.asarray(jdata.qid))


@pytest.mark.parametrize("flags,item", [(["--mesh", "2d"], "A8")])
def test_train_cli_flags_not_ported_raise(flags, item):
    """What the sharded build of ``item`` leaves out of the CLI: the
    threaded runtime builds on one device, so ``--mesh`` beside
    ``--runtime threads`` exits with the reference's message (the mesh
    itself runs: tests/test_torch_mesh.py)."""
    with pytest.raises(SystemExit, match="--mesh applies to the simulated PS engine"):
        ttrain.main(["--arch", "gbdt", "--device", "cpu", "--steps", "2", "--runtime",
                     "threads", *flags])


def test_serve_cli_lm_arch_points_at_a11(capsys):
    """The LM form of the serve CLI (ROADMAP A11's first item) is ported
    (tests/test_torch_moe.py and test_torch_media.py run it), for every
    family: the xLSTM one serves reduced on the CPU; a prompt that does
    not divide into its chunks raises ``ValueError``."""
    tokens = tserve.main(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu", "--batch",
                          "2", "--prompt-len", "32", "--gen", "4"])
    assert tokens.shape == (2, 4)
    assert "xlstm-1.3b-reduced: prefill 2x32" in capsys.readouterr().out
    with pytest.raises(ValueError, match="chunks of 16"):
        tserve.main(["--arch", "xlstm-1.3b", "--device", "cpu", "--prompt-len", "24"])


@pytest.mark.parametrize("flags", [[], ["--backend", "fused", "--objective", "multiclass:3"],
                                   ["--sparse"], ["--objective", "mse"],
                                   ["--objective", "lambdarank"]],
                         ids=["staged", "fused_multiclass", "sparse", "mse", "lambdarank"])
def test_train_cli_runs_on_the_cpu(flags, capsys):
    args = ["--arch", "gbdt", "--device", "cpu", "--steps", "4", "--workers", "2",
            "--log-every", "0", *flags]
    state = ttrain.main(args)
    objective = flags[flags.index("--objective") + 1] if "--objective" in flags else "logistic"
    from repro_torch.core.sgbdt import SGBDTConfig

    _, data = ttrain.gbdt_dataset_for(objective, 0, device="cpu")
    cfg = SGBDTConfig(n_trees=4, objective=objective)
    loss0 = float(train_loss(cfg, data, init_state(cfg, data)))
    assert float(train_loss(cfg, data, state)) < loss0
    assert state.step == 4 and int(state.forest.n_trees) == 4 * cfg.n_outputs
    out = capsys.readouterr().out
    assert "trained in" in out and ("sparse bins" in out) == ("--sparse" in flags)


@pytest.mark.parametrize("engine,quantize,objective", [
    ("wave", "none", "logistic"), ("continuous", "none", "logistic"),
    ("wave", "int8", "logistic"), ("continuous", "int8", "logistic"),
    ("wave", "none", "mse"), ("wave", "none", "lambdarank")])
def test_serve_cli_runs_on_the_cpu(engine, quantize, objective, tmp_path, capsys):
    outs = tserve.main(["--arch", "gbdt", "--device", "cpu", "--trees", "6", "--requests", "8",
                        "--rows", "32", "--ckpt-dir", str(tmp_path), "--engine", engine,
                        "--quantize", quantize, "--objective", objective])
    assert sorted(r.uid for r in outs) == list(range(8))
    steps = {r.model_step for r in outs}
    assert steps == {3, 6} or (engine == "continuous" and steps <= {3, 6} and 3 in steps)
    if engine == "wave":
        assert "hot swap: step 3 -> 6 (reloaded=True)" in capsys.readouterr().out
        assert [r.model_step for r in outs] == [3] * 4 + [6] * 4
    else:
        assert all(r.version in ("half", "full") for r in outs)
    assert all(np.isfinite(r.scores).all() for r in outs)
    assert all(r.scores.ndim == 1 for r in outs)
    if objective == "logistic":  # probabilities
        assert all(((r.scores >= 0) & (r.scores <= 1)).all() for r in outs)
    if objective == "lambdarank":  # the identity link: raw margins about 0
        assert any((r.scores < 0).any() for r in outs)
