"""Sample the schedules the JAX reference's threaded runtime realizes at
the settings of ``tests/test_torch_async.py::
test_reference_runtime_checkpoint_replays_in_the_port``, and count those on
which the port's replay parts from the reference's forest.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/runtime_schedule_ties.py \
        [--runs 128] [--min-child-hess 0.001] [--jitter 0.02] [--out FILE]

Each run: a reference ``AsyncRuntime`` (W = 3, seed 4, the test's decisive
data, depth 3, 8 rounds) halts at fold 5 with checkpoints every 3 folds and
resumes on 2 workers (with ``--jitter S`` each worker of each run sleeps a
seeded uniform [0, S) seconds before every build, ``worker_delay``, which
widens the sample of realized schedules as a loaded machine does); the
port's ``replay_from_checkpoint`` replays the
combined trace on the reference's draws. A run "parts" when the forests'
features or thresholds differ. For the first tree that differs, every
node that splits otherwise below agreeing ancestors is checked to be a tie:
under the node's histogram summed in f64 (the port's gradients on the F
that tree was built on), the two splits' gains agree within 1e-5 of the
larger, as ``chip_smoke.first_tree_departures`` does. A parting that is no
tie is reported as such. The learner takes the test's ``min_child_hess``
(the reference learner's default 1e-3, or 10 as the test asks now).
Prints one JSON object: runs, distinct schedules, partings, ties, the
largest relative gap, and non-ties.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from repro.ps import AsyncRuntime as JAsyncRuntime  # noqa: E402
from repro_torch.kernels import histogram, split_scan  # noqa: E402
from repro_torch.ps import AsyncRuntime, RunTrace  # noqa: E402
from repro_torch.trees.binning import gather_feature_bins  # noqa: E402
from test_torch_async import _cfgs, _decisive_data, _port, _reference_draws  # noqa: E402


class Recording(AsyncRuntime):
    """The port's runtime, keeping each replayed fold's build inputs."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.builds = []

    def _propose(self, f_target, m_prime, feat_mask):
        tree, delta = super()._propose(f_target, m_prime, feat_mask)
        self.builds.append((f_target.clone(), m_prime, feat_mask, tree))
        return tree, delta


def departures(cfg, data, build, want_feature, want_threshold) -> list:
    """Each node of one tree that splits otherwise than the reference's
    (``want_*``) below agreeing ancestors: (node, f64 gain of the
    reference's split, f64 gain of the port's)."""
    f_target, m, mask, tree = build
    lc, b = cfg.learner, cfg.learner.n_bins
    g, _ = cfg.obj.grad_hess(data.labels, f_target)
    fw, tw = torch.as_tensor(want_feature), torch.as_tensor(want_threshold)
    fg, tg = tree.feature, tree.threshold
    heap = torch.zeros(data.n_samples, dtype=torch.int64)
    agree, out = {0}, []
    for i in range((1 << lc.depth) - 1):
        if i > 0 and (i & (i + 1)) == 0:  # a new level: route every sample one step down
            right = gather_feature_bins(data.bins, fw.long()[heap]) > tw[heap]
            heap = 2 * heap + 1 + right.long()
        if i not in agree:
            continue
        if (int(fw[i]), int(tw[i])) == (int(fg[i]), int(tg[i])):
            agree |= {2 * i + 1, 2 * i + 2}
            continue
        on = torch.where(heap == i, 0, -1).to(torch.int32)
        hist = histogram.histogram_plain(data.bins, on, (m * g).double(), m.double(), 1, b)
        gain = split_scan.split_gain_plain(hist, lc.lam, lc.min_child_hess)
        gain = gain.masked_fill(~mask.bool()[None, :, None], float("-inf")).reshape(-1)

        def split_gain(f, t):
            passes = int(f) == 0 and int(t) == b - 1
            return 0.0 if passes else max(float(gain[int(f) * b + int(t)]), 0.0)
        out.append((i, split_gain(fw[i], tw[i]), split_gain(fg[i], tg[i])))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=128)
    ap.add_argument("--min-child-hess", type=float, default=None,
                    help="both learners' min_child_hess (default: the learner's own)")
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="each worker's delay before a build: uniform [0, S) seconds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    jcfg, tcfg = _cfgs()
    if args.min_child_hess is not None:
        jcfg, tcfg = (c._replace(learner=c.learner._replace(min_child_hess=args.min_child_hess))
                      for c in (jcfg, tcfg))
    jdata = _decisive_data()
    tdata = _port(jdata)
    draws = _reference_draws(jcfg, jdata, 4)
    schedules, parted, ties, gaps, not_ties = set(), 0, 0, [], []
    rng = np.random.default_rng(0)
    for run in range(args.runs):
        delays = (args.jitter * rng.random(3)).tolist()
        with tempfile.TemporaryDirectory() as tmp:
            ck = pathlib.Path(tmp) / "ck"
            _, prefix = JAsyncRuntime(jcfg, jdata, n_workers=3, worker_delay=delays).run(
                seed=4, checkpoint_dir=ck, checkpoint_every=3, halt_at_fold=5)
            jstate, combined = JAsyncRuntime(jcfg, jdata, n_workers=2,
                                             worker_delay=delays[:2]).resume(prefix, ck)
            trace = RunTrace.load(combined.save(pathlib.Path(tmp) / "t.json"))
            port = Recording(tcfg, tdata, n_workers=2, draws=draws)
            state = port.replay_from_checkpoint(ck, trace)
        schedules.add((tuple(np.asarray(trace.schedule).tolist()),
                       tuple(np.asarray(trace.key_index).tolist())))
        jf, jt = (np.asarray(getattr(jstate.forest, n)) for n in ("feature", "threshold"))
        tf, tt = state.forest.feature.numpy(), state.forest.threshold.numpy()
        differ = [j for j in range(jf.shape[0]) if not (np.array_equal(jf[j], tf[j])
                                                         and np.array_equal(jt[j], tt[j]))]
        if not differ:
            continue
        parted += 1
        j = differ[0]
        first = len(port.builds) - (int(state.forest.n_trees) - j)  # the replayed fold j
        if first < 0:
            raise AssertionError(f"run {run}: tree {j} differs before the checkpoint")
        for node, gw, gg in departures(tcfg, tdata, port.builds[first], jf[j], jt[j]):
            gap = abs(gw - gg) / max(gw, gg, 1e-30)
            if abs(gw - gg) > 1e-5 * max(gw, gg):
                not_ties.append({"run": run, "tree": j, "node": node, "gains": [gw, gg]})
            else:
                ties += 1
                gaps.append(gap)
    result = {"runs": args.runs, "jitter_s": args.jitter, "distinct_schedules": len(schedules),
              "min_child_hess": tcfg.learner.min_child_hess, "runs_parted": parted,
              "departing_nodes_that_tie": ties, "largest_relative_gap": max(gaps, default=0.0),
              "departures_without_a_tie": not_ties}
    print(json.dumps(result))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
