"""Host-asynchronous parameter-server runtime (twin of ``repro.ps.runtime``):
real threads, recorded k(j), elastic membership, sharded pulls,
crash-resume.

Everything else in ``repro_torch.ps`` *replays* a delay schedule. This
module is the other half of the paper's claim: W real worker threads race
a server fold loop, and the version map k(j) is *realized* by the race,
not chosen.

Roles (Algorithm 3, but actually concurrent):

  worker thread — atomically grab a build ticket ``i`` and a snapshot of
                  the freshest ``(version, F)`` pair, build a tree from it
                  with the ticket's draws (``engine.round_draws``), and
                  push ``(ticket, pulled_version, tree, delta)`` onto the
                  server queue;
  server loop   — pop pushes in arrival order, fold each
                  (``engine.server_fold``), publish the bumped
                  ``(version, F)``, and append one ``RunTrace`` row.

On the card every worker thread launches on a CUDA stream of its own
(PyTorch's current stream is per thread, and every kernel wrapper launches
on it), so builds overlap on the device as the reference's overlap in
XLA's thread pool. A worker waits for its own stream before it pushes
(the reference's ``block_until_ready(delta)``), never for the device, and
the server waits for its stream after each fold. Tensors that cross
streams (the F snapshot a worker pulls, the tree and delta it pushes) are
recorded on the stream that reads them, so the caching allocator never
hands their memory to another stream while a kernel still reads it.

Determinism by record-and-replay: the interleaving is nondeterministic,
but every folded tree is a pure function of ``(F^{k(j)}, ticket i(j))``.
``RunTrace`` records the realized schedule k(j) and the ticket permutation
i(j); replaying them through ``Trainer.scan_with`` reproduces the threaded
run's forest bit for bit: the same kernels run on the same inputs, and
none of them adds in an order that depends on the stream or thread
(DESIGN.md §11, §14).

On top of that contract the runtime is ELASTIC and CRASH-SAFE:

  * ``FaultPlan`` injects deterministic membership faults: crash or
    graceful leave when a chosen ticket is first issued, (re)join when the
    server reaches a chosen fold count. A crashed ticket is re-issued, so
    ``key_index`` stays a permutation and the trace still replays exactly;
    every membership change is a trace EVENT and bumps the EPOCH.
  * ``shard_pulls = P`` shards the server's leaf table (the F vector) into
    P contiguous row partitions: a worker draws its Bernoulli sample FIRST
    and pulls only the partitions its sampled rows touch (rowwise
    objectives only). Unpulled rows are zero-filled, bitwise harmless
    because unsampled rows carry m' = 0, and the realized ``pull_bytes``
    land in the trace.
  * periodic runtime checkpoints save the server state AND every F version
    still referenced by an in-flight build (``checkpoint.store``, the
    reference's format), so any recorded trace suffix replays from the
    checkpoint alone (``replay_from_checkpoint``), and a killed run
    resumes from checkpoint + trace prefix (``resume``) with the lost
    in-flight tickets re-issued to the new worker set.
  * with ``cfg.adaptive_step = rho``, the server deflates each fold by
    1/(1 + 6*rho*tau_j) using the staleness OBSERVED at fold time
    (``engine.scale_push``), and the realized scales are recorded.

The trace also carries measured per-phase wall times, which parameterize
``core.simulator.ClusterSpec`` (``RunTrace.crossvalidate``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import pathlib
import queue
import threading
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core.sgbdt import SGBDTConfig, TrainState, init_state
from repro_torch.ps.engine import (
    Draws,
    Trainer,
    fold_push,
    propose_tree,
    round_draws,
    unpack_draws,
)
from repro_torch.ps.schedules import max_staleness, resolve_schedule
from repro_torch.trees.binning import BinnedData
from repro_torch.trees.forest import Forest

_TRACE_VERSION = 2
# Row arrays by the schema version that introduced them. v1 traces load
# forever (the defaults reconstruct pre-elastic semantics: one epoch, no
# events, unrecorded pull bytes, fixed step).
_ARRAYS_V1 = {
    "schedule": np.int32,
    "key_index": np.int32,
    "worker": np.int32,
    "t_build": np.float64,
    "t_queue": np.float64,
    "t_fold": np.float64,
}
_ARRAYS_V2 = {
    **_ARRAYS_V1,
    "epoch": np.int32,
    "pull_bytes": np.int64,
    "step_scale": np.float32,
}
_SCALARS_V1 = {"trace_version", "n_workers", "seed", "makespan"}
_SCALARS_V2 = _SCALARS_V1 | {"n_parts", "full_pull_bytes", "adaptive_rho"}
# Saved for humans/dashboards; recomputed from the arrays on load.
_DERIVED = {"summary", "staleness_histogram"}
_KNOWN_FIELDS = {
    1: set(_ARRAYS_V1) | _SCALARS_V1 | _DERIVED,
    2: set(_ARRAYS_V2) | _SCALARS_V2 | {"events"} | _DERIVED,
}

_EVENT_KINDS = ("join", "leave", "crash", "resume")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault injection for ``AsyncRuntime``.

    ``crash_tickets``  — crash the worker that FIRST draws each listed
                         ticket: the ticket is returned to the pool
                         (another worker rebuilds it), the thread dies,
                         and a ``crash`` event is recorded. Re-issues of
                         the same ticket do not crash again.
    ``leave_tickets``  — graceful leave: the worker that draws the ticket
                         builds and pushes it, then deregisters (a
                         ``leave`` event; no work is lost).
    ``join_at``        — ``{worker_id: fold_count}``: start a (new or
                         rejoining) worker thread with that id once the
                         server has folded ``fold_count`` trees.

    All three key off deterministic counters (ticket numbers, fold
    counts), not wall time — the same plan on the same geometry produces
    the same membership event set, and the resulting trace replays
    bit-for-bit like any other.
    """

    crash_tickets: frozenset = frozenset()
    leave_tickets: frozenset = frozenset()
    join_at: Mapping[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(
            self, "crash_tickets", frozenset(int(t) for t in self.crash_tickets)
        )
        object.__setattr__(
            self, "leave_tickets", frozenset(int(t) for t in self.leave_tickets)
        )
        object.__setattr__(
            self, "join_at", {int(w): int(j) for w, j in dict(self.join_at).items()}
        )
        if self.crash_tickets & self.leave_tickets:
            raise ValueError("a ticket cannot both crash and leave its worker")
        if any(t < 0 for t in self.crash_tickets | self.leave_tickets):
            raise ValueError("fault tickets must be >= 0")
        if any(j < 0 for j in self.join_at.values()):
            raise ValueError("join_at fold counts must be >= 0")

    @property
    def empty(self) -> bool:
        return not (self.crash_tickets or self.leave_tickets or self.join_at)


@dataclasses.dataclass(frozen=True)
class RunTrace:
    """The realized execution of one threaded run — enough to replay it.

    Row j describes server update j (fold order):
      schedule[j]   — k(j): the version the folded tree was built from;
      key_index[j]  — i(j): the build ticket, i.e. ``keys[i(j)]`` was the
                      round key (a permutation of ``arange(n_trees)``);
      worker[j]     — which worker thread built it;
      epoch[j]      — the membership epoch the build STARTED in (bumped by
                      every join/leave/crash/resume event);
      pull_bytes[j] — bytes the build's leaf-table pull actually moved
                      (full table, or only the touched partitions under
                      ``shard_pulls``);
      step_scale[j] — the staleness-adaptive deflation the server applied
                      at fold time (1.0 when ``adaptive_rho == 0``);
      t_build[j]    — wall seconds of the build, to its stream's end;
      t_queue[j]    — push-to-fold-start wait in the server queue;
      t_fold[j]     — wall seconds of the server fold, to its stream's end.

    ``events`` is the membership log: tuples of dicts with ``kind`` in
    ``join | leave | crash | resume``, the worker, the fold count and
    ticket at which the event fired, and the epoch it opened.
    """

    n_workers: int
    seed: int
    schedule: np.ndarray
    key_index: np.ndarray
    worker: np.ndarray
    t_build: np.ndarray
    t_queue: np.ndarray
    t_fold: np.ndarray
    makespan: float
    epoch: np.ndarray | None = None
    pull_bytes: np.ndarray | None = None
    step_scale: np.ndarray | None = None
    events: tuple = ()
    n_parts: int = 0
    full_pull_bytes: int = 0
    adaptive_rho: float = 0.0

    def __post_init__(self):
        n = len(np.asarray(self.schedule))
        fills = {
            "epoch": np.zeros(n, np.int32),
            "pull_bytes": np.full(n, int(self.full_pull_bytes), np.int64),
            "step_scale": np.ones(n, np.float32),
        }
        for name, dtype in _ARRAYS_V2.items():
            val = getattr(self, name)
            if val is None:
                val = fills[name]
            object.__setattr__(self, name, np.asarray(val, dtype))
            if getattr(self, name).shape != (n,):
                raise ValueError(f"trace array {name!r} is not shaped ({n},)")
        events = tuple(dict(e) for e in self.events)
        for e in events:
            if e.get("kind") not in _EVENT_KINDS:
                raise ValueError(f"unknown membership event kind: {e!r}")
        object.__setattr__(self, "events", events)

    @property
    def n_trees(self) -> int:
        return len(self.schedule)

    @property
    def staleness(self) -> np.ndarray:
        return np.arange(self.n_trees) - self.schedule

    @property
    def ring_size(self) -> int:
        return max_staleness(self.schedule) + 1

    @property
    def n_epochs(self) -> int:
        return int(self.epoch.max()) + 1 if self.n_trees else 1

    def membership_deltas(self) -> list[tuple[int, int]]:
        """``(fold, +-1)`` worker-count changes, the shape
        ``core.simulator.simulate_elastic`` takes as ``membership``."""
        out = []
        for e in self.events:
            if e["kind"] == "join":
                out.append((int(e["fold"]), 1))
            elif e["kind"] in ("leave", "crash"):
                out.append((int(e["fold"]), -1))
        return out

    def staleness_histogram(self) -> dict[int, int]:
        return self._staleness_stats()["histogram"]

    def _staleness_stats(self) -> dict:
        from repro_torch.core.simulator import staleness_stats

        return staleness_stats(self.schedule)

    def cluster_spec(self, **overrides):
        """A ``ClusterSpec`` parameterized by this run's measured phases.

        ``t_comm`` maps to the in-process queue handoff (there is no wire
        here); jitter/spread coefficients keep their defaults unless
        overridden.
        """
        from repro_torch.core.simulator import ClusterSpec

        args = dict(
            n_workers=self.n_workers,
            t_build=float(self.t_build.mean()),
            t_comm=float(self.t_queue.mean()),
            t_server=float(self.t_fold.mean()),
            seed=self.seed,
        )
        args.update(overrides)
        return ClusterSpec(**args)

    def crossvalidate(self, **spec_overrides) -> dict:
        """Realized staleness vs. the event-driven simulator's prediction
        for the same cluster geometry — elastic runs forward their
        membership deltas to ``simulate_elastic``, adaptive runs also get
        realized-vs-predicted effective-step statistics
        (``core.simulator.crossvalidate_schedule``)."""
        from repro_torch.core.simulator import crossvalidate_schedule

        return crossvalidate_schedule(
            self.schedule,
            self.cluster_spec(**spec_overrides),
            makespan=self.makespan,
            membership=self.membership_deltas(),
            adaptive_rho=self.adaptive_rho,
        )

    def summary(self) -> dict:
        stats = self._staleness_stats()
        out = {
            "n_trees": self.n_trees,
            "n_workers": self.n_workers,
            "makespan_s": float(self.makespan),
            "mean_staleness": stats["mean_staleness"],
            "max_staleness": stats["max_staleness"],
            "t_build_mean_s": float(self.t_build.mean()),
            "t_queue_mean_s": float(self.t_queue.mean()),
            "t_fold_mean_s": float(self.t_fold.mean()),
            "n_epochs": self.n_epochs,
            "n_events": len(self.events),
        }
        if self.n_parts and self.full_pull_bytes:
            out["pull_bytes_mean"] = float(self.pull_bytes.mean())
            out["pull_bytes_full"] = int(self.full_pull_bytes)
            out["pull_reduction"] = 1.0 - float(self.pull_bytes.mean()) / float(
                self.full_pull_bytes
            )
        if self.adaptive_rho:
            out["step_scale_mean"] = float(self.step_scale.mean())
        return out

    # ------------------------------------------------------------- trace io
    def to_json(self) -> dict:
        out = {
            "trace_version": _TRACE_VERSION,
            "n_workers": self.n_workers,
            "seed": self.seed,
            "makespan": float(self.makespan),
            "n_parts": int(self.n_parts),
            "full_pull_bytes": int(self.full_pull_bytes),
            "adaptive_rho": float(self.adaptive_rho),
            "events": list(self.events),
            "summary": self.summary(),
            "staleness_histogram": {
                str(k): v for k, v in self.staleness_histogram().items()
            },
        }
        for name in _ARRAYS_V2:
            out[name] = np.asarray(getattr(self, name)).tolist()
        return out

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(self.to_json(), indent=1))
        tmp.replace(path)  # atomic: a crash mid-write never truncates
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "RunTrace":
        """Version-tagged loader: v1 and v2 traces load; anything else —
        an unknown version, a missing tag, or fields no schema defines —
        fails LOUDLY instead of being silently dropped (a trace that does
        not fully round-trip is a replay you cannot trust)."""
        d = json.loads(pathlib.Path(path).read_text())
        version = d.get("trace_version")
        if version not in _KNOWN_FIELDS:
            raise ValueError(
                f"{path}: unknown RunTrace schema version {version!r} "
                f"(this build reads {sorted(_KNOWN_FIELDS)}); refusing to "
                "guess at field semantics"
            )
        unknown = set(d) - _KNOWN_FIELDS[version]
        if unknown:
            raise ValueError(
                f"{path}: fields {sorted(unknown)} are not part of trace "
                f"schema v{version}; refusing to silently drop them"
            )
        arrays = _ARRAYS_V1 if version == 1 else _ARRAYS_V2
        kw = {
            name: np.asarray(d[name], dtype) for name, dtype in arrays.items()
        }
        if version >= 2:
            kw.update(
                events=tuple(d.get("events", ())),
                n_parts=int(d.get("n_parts", 0)),
                full_pull_bytes=int(d.get("full_pull_bytes", 0)),
                adaptive_rho=float(d.get("adaptive_rho", 0.0)),
            )
        return cls(
            n_workers=int(d["n_workers"]),
            seed=int(d["seed"]),
            makespan=float(d["makespan"]),
            **kw,
        )


class _LeafTableShards:
    """Contiguous row partitioning of the server's leaf table (the F
    vector) and the partial pull: F masked to the partitions the ticket's
    Bernoulli sample ``q_any`` touches, and the realized bytes (a P-bit
    request bitmap + 4 bytes per pulled row per output), as the reference
    counts them.

    Why masking is exact: the sample depends only on the ticket, never on
    F, so the worker knows its sampled rows BEFORE pulling; every unsampled
    row carries importance weight m' = +0.0, and for a rowwise objective
    that row's (wrong) gradient enters the build only as ``0.0 * g``, a
    signed zero, so histogram sums, splits and leaves match the full-pull
    build. The one residual is the zero's SIGN: a leaf summing ONLY
    unsampled rows can flip -0.0/+0.0 if the masked gradient's sign
    differs from the true one. For logloss and softmax the sign is
    label-determined (independent of F), closing even that corner.
    """

    def __init__(self, cfg: SGBDTConfig, data: BinnedData, n_parts: int):
        n = data.n_samples
        if not 1 <= n_parts <= n:
            raise ValueError(
                f"shard_pulls must be in [1, n_samples={n}], got {n_parts}"
            )
        if not cfg.obj.rowwise:
            raise ValueError(
                f"objective {cfg.obj.name!r} is not rowwise (its gradients "
                "mix rows); sharded leaf-table pulls need the full table"
            )
        self.n_parts = n_parts
        sizes = np.full(n_parts, n // n_parts, np.int32)
        sizes[: n % n_parts] += 1
        self.part_sizes = sizes
        self.part_ids = np.repeat(np.arange(n_parts, dtype=np.int32), sizes)
        self.request_bytes = (n_parts + 7) // 8
        self.k_out = cfg.obj.n_outputs
        dev = data.bins.device
        self._part_ids = torch.as_tensor(self.part_ids, dtype=torch.long, device=dev)
        self._part_sizes = torch.as_tensor(sizes, dtype=torch.long, device=dev)

    def pull(self, f: torch.Tensor, q_any: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(F with the untouched partitions' rows +0.0, bytes moved). Reads
        the byte count on the host: waits for the caller's stream only."""
        hits = torch.zeros(self.n_parts, dtype=torch.int32, device=f.device)
        touched = hits.index_add_(0, self._part_ids, q_any.to(torch.int32)) > 0
        row_mask = touched[self._part_ids]
        mask = row_mask if f.ndim == 1 else row_mask[:, None]
        f_masked = torch.where(mask, f, torch.zeros((), dtype=f.dtype, device=f.device))
        pulled_rows = int(self._part_sizes[touched].sum())
        return f_masked, 4 * self.k_out * pulled_rows + self.request_bytes


def _on(stream):
    """The context that makes ``stream`` the calling thread's current
    stream (nothing on the CPU, where there is none)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _done(stream) -> None:
    """Wait for ``stream``'s work (the reference's ``block_until_ready``);
    on the CPU the work is done on return."""
    if stream is not None:
        stream.synchronize()


class AsyncRuntime:
    """W real worker threads against a server fold loop, with tracing.

    ``worker_delay`` injects stragglers: ``{worker_id: seconds}`` slept
    inside that worker's build phase (between pull and push), modeling a
    slow node: its pushes arrive late and stale while the fast workers keep
    folding. ``faults`` injects deterministic membership churn
    (``FaultPlan``); ``shard_pulls = P`` enables partition-granular leaf
    table pulls. ``cfg.adaptive_step = rho > 0`` turns on the
    staleness-adaptive server fold. ``draws``, when given, replaces
    ``engine.round_draws``: ``draws[i]`` is ticket i's (the parity tests
    inject the reference's). The runtime runs on the data's device; on the
    card each worker thread and the server get a CUDA stream of their own.
    """

    def __init__(
        self,
        cfg: SGBDTConfig,
        data: BinnedData,
        n_workers: int,
        *,
        worker_delay: Mapping[int, float] | Sequence[float] | None = None,
        faults: FaultPlan | None = None,
        shard_pulls: int = 0,
        draws: Sequence[Draws] | None = None,
    ):
        if n_workers < 1:
            raise ValueError(f"need >= 1 worker, got {n_workers}")
        self.cfg = cfg
        self.data = data
        self.n_workers = n_workers
        self.device = data.bins.device
        self.draws = draws
        self.faults = faults if faults is not None else FaultPlan()
        if any(j > cfg.n_trees for j in self.faults.join_at.values()):
            raise ValueError("join_at fold count beyond the end of the run")
        self.shards = (
            _LeafTableShards(cfg, data, shard_pulls) if shard_pulls else None
        )
        self.full_pull_bytes = 4 * cfg.obj.n_outputs * data.n_samples
        if worker_delay is None:
            self._delay = {}
        elif isinstance(worker_delay, Mapping):
            self._delay = dict(worker_delay)
        else:
            self._delay = dict(enumerate(worker_delay))
        self.trainer = Trainer(cfg, device=self.device)

    # The worker's and the server's halves of ``engine.round_body``, the ops
    # the replay runs in the same order on the same inputs.
    def _ticket_draws(self, seed: int, i: int):
        if self.draws is not None:
            return unpack_draws(self.draws[i])
        return round_draws(self.cfg, self.data, seed, i)

    def _propose(self, f_target, m_prime, feat_mask):
        return propose_tree(self.cfg, self.data, f_target, None, m_prime, feat_mask)

    def _fold(self, forest, f, tree, delta, stale: int):
        return fold_push(self.cfg, self.data, forest, f, tree, delta, stale)

    def _stream(self):
        """A new CUDA stream on the runtime's device (None on the CPU)."""
        return torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # ----------------------------------------------------------------- run
    def run(
        self,
        seed: int = 0,
        *,
        checkpoint_dir: str | pathlib.Path | None = None,
        checkpoint_every: int = 0,
        halt_at_fold: int | None = None,
        trace_path: str | pathlib.Path | None = None,
    ) -> tuple[TrainState, RunTrace]:
        """Run the threaded PS loop from scratch.

        ``checkpoint_dir`` + ``checkpoint_every`` write a runtime
        checkpoint every K folds (server state + every F version an
        in-flight build still references; see ``replay_from_checkpoint``).
        ``halt_at_fold = J`` simulates a whole-process crash: the server
        stops after J folds and returns the PREFIX trace (the workers are
        abandoned and take no new ticket); resume later with ``resume``.
        ``trace_path`` writes the trace to disk after every fold, so a
        real crash leaves a loadable prefix behind.
        """
        state = init_state(self.cfg, self.data)
        return self._execute(
            seed,
            forest=state.forest,
            f=state.f,
            start_fold=0,
            pending=list(range(self.cfg.n_trees)),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            halt_at_fold=halt_at_fold,
            trace_path=trace_path,
        )

    def resume(
        self,
        prefix: RunTrace,
        checkpoint_dir: str | pathlib.Path,
        *,
        checkpoint_every: int = 0,
        halt_at_fold: int | None = None,
        trace_path: str | pathlib.Path | None = None,
    ) -> tuple[TrainState, RunTrace]:
        """Resume a killed run from its checkpoint + trace prefix.

        Reconstructs the server state at ``prefix.n_trees`` folds by
        loading the newest checkpoint at or before the prefix end and
        replaying the prefix rows past it, then CONTINUES the threaded
        run: tickets the prefix never folded (including any that were in
        flight at the crash) are re-issued to this runtime's worker set.
        Returns the final state plus the COMBINED trace (prefix rows
        verbatim, continuation rows appended, a ``resume`` membership
        event marking the seam), which replays bit for bit like any other.
        """
        j_prefix = prefix.n_trees
        if j_prefix >= self.cfg.n_trees:
            raise ValueError(
                f"prefix already has {j_prefix} folds; nothing to resume "
                f"for cfg.n_trees={self.cfg.n_trees}"
            )
        forest, f, _ = self._restore_to_fold(
            checkpoint_dir, prefix, j_prefix, seed=prefix.seed
        )
        # continuation workers pull the current version only
        folded = set(int(i) for i in prefix.key_index)
        pending = sorted(set(range(self.cfg.n_trees)) - folded)
        last_epoch = int(prefix.epoch.max()) if j_prefix else 0
        last_epoch = max(
            [last_epoch] + [int(e["epoch"]) for e in prefix.events]
        )
        epoch0 = last_epoch + 1
        resume_event = {
            "kind": "resume",
            "worker": -1,
            "ticket": -1,
            "fold": j_prefix,
            "epoch": epoch0,
        }
        prefix_rows = {
            name: np.asarray(getattr(prefix, name)) for name in _ARRAYS_V2
        }
        return self._execute(
            prefix.seed,
            forest=forest,
            f=f,
            start_fold=j_prefix,
            pending=pending,
            prefix_rows=prefix_rows,
            base_events=prefix.events + (resume_event,),
            base_epoch=epoch0,
            base_makespan=float(prefix.makespan),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            halt_at_fold=halt_at_fold,
            trace_path=trace_path,
        )

    # ------------------------------------------------------- replay/resume
    def replay_from_checkpoint(
        self,
        checkpoint_dir: str | pathlib.Path,
        trace: RunTrace,
    ) -> TrainState:
        """Re-execute ``trace``'s suffix from the newest checkpoint at or
        before its end: the crash-resume core, minus the threads. The
        checkpoint stashes every F version in-flight builds referenced, so
        any suffix row's ``F^{k(j)}`` is available, and the same propose
        and fold the threaded run used reproduce its forest bit for bit."""
        forest, f, _ = self._restore_to_fold(
            checkpoint_dir, trace, trace.n_trees, seed=trace.seed
        )
        return TrainState(forest=forest, f=f, step=trace.n_trees)

    def _restore_to_fold(self, checkpoint_dir, trace, upto: int, seed: int):
        """(forest, f, versions) at fold ``upto``: newest checkpoint <=
        ``upto``, then replay trace rows [ckpt_step, upto)."""
        avail = [s for s in ckpt_store.steps(checkpoint_dir) if s <= upto]
        if not avail:
            raise ValueError(
                f"no checkpoint at or before fold {upto} under "
                f"{checkpoint_dir}"
            )
        step = avail[-1]
        ckpt = self._load_checkpoint(checkpoint_dir, step)
        forest, f = ckpt["forest"], ckpt["f"]
        versions = {
            int(v): ckpt["held_f"][i]
            for i, v in enumerate(ckpt["held_versions"].tolist())
        }
        versions[step] = f
        schedule = np.asarray(trace.schedule)
        key_index = np.asarray(trace.key_index)
        # last fold that still reads each version, for GC as we go
        last_use = {int(k): j for j, k in enumerate(schedule[:upto])}
        for j in range(step, upto):
            k = int(schedule[j])
            if k not in versions:
                raise ValueError(
                    f"checkpoint step {step} cannot serve F^{k} needed by "
                    f"fold {j}: the trace and checkpoint are from different "
                    "runs, or the checkpoint predates this schema"
                )
            m_prime, _, feat_mask = self._ticket_draws(seed, int(key_index[j]))
            tree, delta = self._propose(versions[k], m_prime, feat_mask)
            forest, f = self._fold(forest, f, tree, delta, j - k)
            versions[j + 1] = f
            for v in [v for v, last in last_use.items() if last == j]:
                if v in versions and v != j + 1:
                    del versions[v]
        return forest, f, versions

    def _load_checkpoint(self, checkpoint_dir, step: int) -> dict:
        manifest = ckpt_store.leaf_manifest(checkpoint_dir, step)
        held_shape = next(
            tuple(e["shape"])
            for p, e in manifest.items()
            if "held_f" in p
        )
        state = init_state(self.cfg, self.data)
        like = {
            "forest": state.forest,
            "f": state.f,
            "step": torch.zeros((), dtype=torch.int32),
            "held_versions": torch.zeros(held_shape[0], dtype=torch.int32),
            "held_f": torch.zeros(held_shape, dtype=torch.float32, device=self.device),
        }
        return ckpt_store.restore_pytree(checkpoint_dir, step, like)

    # ------------------------------------------------------- threaded core
    def _execute(
        self,
        seed: int,
        *,
        forest,
        f,
        start_fold: int,
        pending: list[int],
        prefix_rows: dict | None = None,
        base_events: tuple = (),
        base_epoch: int = 0,
        base_makespan: float = 0.0,
        checkpoint_dir=None,
        checkpoint_every: int = 0,
        halt_at_fold: int | None = None,
        trace_path=None,
    ) -> tuple[TrainState, RunTrace]:
        cfg = self.cfg
        n_trees = cfg.n_trees
        end_fold = n_trees if halt_at_fold is None else int(halt_at_fold)
        if not start_fold < end_fold <= n_trees:
            raise ValueError(
                f"halt_at_fold must be in ({start_fold}, {n_trees}], "
                f"got {halt_at_fold}"
            )
        server_stream = self._stream()
        caller_stream = (torch.cuda.current_stream(self.device) if server_stream is not None
                         else None)

        # Warm up outside the timed region, before any thread starts: one
        # propose and one fold (into a scratch copy of the forest) build and
        # load every kernel library a round needs, so no first use races,
        # and the first worker does not record a build as a compile.
        with _on(server_stream):
            m_prime, q_any, feat_mask = self._ticket_draws(seed, pending[0])
            tree0, delta0 = self._propose(f, m_prime, feat_mask)
            self._fold(Forest(*(t.clone() for t in forest)), f, tree0, delta0, 0)
            if self.shards is not None:
                self.shards.pull(f, q_any)
            del tree0, delta0
        if server_stream is not None:
            torch.cuda.synchronize(self.device)  # the inputs too, made on other streams

        lock = threading.Lock()
        pushes: "queue.Queue[tuple]" = queue.Queue()
        # Everything workers and the fold loop both touch is guarded-by
        # `lock`.
        shared = {  # guarded-by: lock
            "version": start_fold,
            "f": f,
            "epoch": base_epoch,
            "fold": start_fold,
            "live": set(),
            # Tickets whose first issue already crashed, seeded from the
            # prefix on resume, so a re-issued ticket never crashes twice.
            "crashed": {
                int(e["ticket"]) for e in base_events if e["kind"] == "crash"
            },
            # Set at a simulated halt: the abandoned workers take no new
            # ticket.
            "halted": False,
        }
        ticket_heap = list(pending)  # guarded-by: lock
        heapq.heapify(ticket_heap)
        f_by_version: dict[int, torch.Tensor] = {start_fold: f}  # guarded-by: lock
        refcnt: dict[int, int] = {}  # guarded-by: lock
        events: list[dict] = list(base_events)  # guarded-by: lock
        errors: list[BaseException] = []
        joins = dict(self.faults.join_at)  # guarded-by: lock
        plan = self.faults

        def worker(w: int, stream) -> None:
            delay = float(self._delay.get(w, 0.0))
            try:
                with _on(stream):
                    while True:
                        with lock:
                            if not ticket_heap or shared["halted"]:
                                shared["live"].discard(w)
                                return
                            i = heapq.heappop(ticket_heap)
                            if i in plan.crash_tickets and i not in shared["crashed"]:
                                # Crash: the ticket bounces back for
                                # re-issue, this thread dies. Atomic under
                                # the lock, so no sibling ever observes the
                                # ticket missing.
                                shared["crashed"].add(i)
                                heapq.heappush(ticket_heap, i)
                                shared["epoch"] += 1
                                shared["live"].discard(w)
                                events.append({
                                    "kind": "crash", "worker": w, "ticket": i,
                                    "fold": shared["fold"],
                                    "epoch": shared["epoch"],
                                })
                                return
                            pulled_version = shared["version"]
                            f_snapshot = shared["f"]
                            refcnt[pulled_version] = refcnt.get(pulled_version, 0) + 1
                            my_epoch = shared["epoch"]
                        t0 = time.perf_counter()
                        if stream is not None:  # made on the server's stream
                            f_snapshot.record_stream(stream)
                        m_prime, q_any, feat_mask = self._ticket_draws(seed, i)
                        if self.shards is not None:
                            f_used, nbytes = self.shards.pull(f_snapshot, q_any)
                        else:
                            f_used, nbytes = f_snapshot, self.full_pull_bytes
                        tree, delta = self._propose(f_used, m_prime, feat_mask)
                        if delay:
                            time.sleep(delay)
                        _done(stream)
                        t_build = time.perf_counter() - t0
                        pushes.put(
                            (i, pulled_version, w, my_epoch, nbytes, tree, delta,
                             t_build, time.perf_counter())
                        )
                        del f_snapshot, f_used, tree, delta
                        if i in plan.leave_tickets:
                            with lock:
                                shared["epoch"] += 1
                                shared["live"].discard(w)
                                events.append({
                                    "kind": "leave", "worker": w, "ticket": i,
                                    "fold": shared["fold"],
                                    "epoch": shared["epoch"],
                                })
                            return
            except BaseException as e:  # surface worker failures to the server
                errors.append(e)
                pushes.put(None)

        def start_worker(w: int) -> threading.Thread:  # holds-lock: lock
            shared["live"].add(w)
            t = threading.Thread(target=worker, args=(w, self._stream()), daemon=True)
            t.start()
            return t

        def fire_joins(fold: int) -> None:  # holds-lock: lock
            for w in [w for w, at in joins.items() if at <= fold]:
                del joins[w]
                shared["epoch"] += 1
                events.append({
                    "kind": "join", "worker": w, "ticket": -1,
                    "fold": fold, "epoch": shared["epoch"],
                })
                threads.append(start_worker(w))

        rows = {
            name: np.zeros(n_trees, dtype) for name, dtype in _ARRAYS_V2.items()
        }
        if prefix_rows is not None:
            for name in _ARRAYS_V2:
                rows[name][:start_fold] = prefix_rows[name][:start_fold]

        rho = float(cfg.adaptive_step)
        threads: list[threading.Thread] = []
        t_start = time.perf_counter()
        with lock:
            for w in range(self.n_workers):
                threads.append(start_worker(w))
            fire_joins(start_fold)

        def partial_trace(upto: int, makespan: float) -> RunTrace:  # concurrent
            # Runs on the server thread, but abandoned workers may still be
            # appending events: snapshot under the lock.
            with lock:
                events_snapshot = tuple(events)
            return RunTrace(
                n_workers=self.n_workers,
                seed=seed,
                makespan=makespan,
                events=events_snapshot,
                n_parts=self.shards.n_parts if self.shards else 0,
                full_pull_bytes=self.full_pull_bytes,
                adaptive_rho=rho,
                **{name: rows[name][:upto].copy() for name in _ARRAYS_V2},
            )

        j = start_fold
        with _on(server_stream):
            while j < end_fold:
                try:
                    push = pushes.get(timeout=1.0)
                except queue.Empty:
                    with lock:
                        stuck = not shared["live"] and not joins
                    if stuck:
                        raise RuntimeError(
                            f"no live workers and no pending joins with "
                            f"{end_fold - j} folds outstanding: the fault plan "
                            "killed everyone (rejoins fire on fold counts; a "
                            "rejoin threshold no surviving worker can reach "
                            "deadlocks the run)"
                        )
                    continue
                if push is None:
                    with lock:
                        shared["halted"] = True  # the others stop at their next ticket
                    raise RuntimeError("async worker failed") from errors[0]
                (i, pulled_version, w, my_epoch, nbytes, tree, delta,
                 t_build, t_pushed) = push
                del push
                if server_stream is not None:  # made on the worker's stream
                    for t in (*tree, delta):
                        t.record_stream(server_stream)
                t_fold0 = time.perf_counter()
                forest, f = self._fold(forest, f, tree, delta, j - pulled_version)
                _done(server_stream)
                t_fold1 = time.perf_counter()
                del tree, delta
                with lock:
                    shared["version"] = j + 1
                    shared["f"] = f
                    shared["fold"] = j + 1
                    f_by_version[j + 1] = f
                    refcnt[pulled_version] -= 1
                    for v in [v for v, c in refcnt.items() if c <= 0]:
                        del refcnt[v]
                    # Keep only versions a still-in-flight build references,
                    # plus the current one; everything else is garbage.
                    for v in [
                        v for v in f_by_version if v != j + 1 and v not in refcnt
                    ]:
                        del f_by_version[v]
                    fire_joins(j + 1)
                    held = sorted(v for v, c in refcnt.items() if c > 0)
                    held_f = [f_by_version[v] for v in held]
                rows["schedule"][j] = pulled_version
                rows["key_index"][j] = i
                rows["worker"][j] = w
                rows["epoch"][j] = my_epoch
                rows["pull_bytes"][j] = nbytes
                # Same f32 rounding as engine.staleness_scale: 6*rho rounds
                # once from python f64, then one f32 mul + add + divide.
                rows["step_scale"][j] = (
                    np.float32(1.0)
                    / (np.float32(1.0) + np.float32(6.0 * rho) * np.float32(j - pulled_version))
                    if rho
                    else np.float32(1.0)
                )
                rows["t_build"][j] = t_build
                rows["t_queue"][j] = t_fold0 - t_pushed
                rows["t_fold"][j] = t_fold1 - t_fold0
                j += 1
                if checkpoint_dir is not None and checkpoint_every and (
                    j % checkpoint_every == 0 or j == end_fold
                ):
                    self._save_checkpoint(checkpoint_dir, j, forest, f, held, held_f)
                if trace_path is not None:
                    partial_trace(
                        j, base_makespan + time.perf_counter() - t_start
                    ).save(trace_path)

        makespan = base_makespan + time.perf_counter() - t_start
        if halt_at_fold is None:
            for t in threads:
                t.join()
        else:  # simulated process crash: abandon the daemon workers
            with lock:
                shared["halted"] = True

        trace = partial_trace(end_fold, makespan)
        if trace_path is not None:
            trace.save(trace_path)
        if halt_at_fold is None:
            # The realized schedule must be a valid causal k(j) and the
            # tickets a permutation: the replay contract's preconditions.
            resolve_schedule(trace.schedule, n_trees)
            if sorted(trace.key_index.tolist()) != list(range(n_trees)):
                raise RuntimeError("the folded tickets are not a permutation of the rounds")
        if caller_stream is not None:
            # The state was made on the server's stream and is read next on
            # the caller's: its memory must outlive the caller's reads too
            # (pool streams come back to the next run).
            for t in (*forest, f):
                t.record_stream(caller_stream)
        return TrainState(forest=forest, f=f, step=end_fold), trace

    def _save_checkpoint(
        self, checkpoint_dir, fold: int, forest, f, held, held_f
    ) -> None:
        """Server state at ``fold`` plus the stale F versions in-flight
        builds still reference: exactly what a trace-suffix replay needs
        (every suffix row's k(j) is either >= fold or held by a build that
        had pulled it before the checkpoint)."""
        stacked = (
            torch.stack(held_f)
            if held_f
            else torch.zeros((0,) + tuple(f.shape), dtype=torch.float32)
        )
        ckpt_store.save_pytree(
            checkpoint_dir,
            fold,
            {
                "forest": forest,
                "f": f,
                "step": np.asarray(fold, np.int32),
                "held_versions": np.asarray(held, np.int32),
                "held_f": stacked,
            },
        )

    # -------------------------------------------------------------- replay
    def replay(self, trace: RunTrace) -> tuple[TrainState, torch.Tensor]:
        """Re-execute a recorded run deterministically (the loop form)."""
        return replay_trace(self.cfg, self.data, trace, trainer=self.trainer,
                            draws=self.draws)


def replay_trace(
    cfg: SGBDTConfig,
    data: BinnedData,
    trace: RunTrace,
    *,
    trainer: Trainer | None = None,
    draws: Sequence[Draws] | None = None,
) -> tuple[TrainState, torch.Tensor]:
    """Replay a ``RunTrace`` through ``Trainer.scan_with`` on the data's
    device.

    Feeds the realized k(j) and the ticket permutation back through the
    deterministic engine (ticket i's draws ``round_draws(cfg, data,
    trace.seed, i)``, or ``draws[i]``); the returned forest is bit-identical
    to the threaded run that recorded the trace. Elastic traces replay the
    same way: membership only decided WHICH worker realized each (k(j),
    i(j)) row, never the row's math.
    """
    if trace.n_trees != cfg.n_trees:
        raise ValueError(
            f"trace has {trace.n_trees} rounds but cfg.n_trees={cfg.n_trees}"
        )
    if float(trace.adaptive_rho) != float(cfg.adaptive_step):
        raise ValueError(
            f"trace was recorded with adaptive_rho={trace.adaptive_rho} but "
            f"cfg.adaptive_step={cfg.adaptive_step}: the replayed folds "
            "would apply different step scales"
        )
    if trainer is None:
        trainer = Trainer(cfg, device=data.bins.device)
    schedule = resolve_schedule(trace.schedule, cfg.n_trees)
    return trainer.scan_with(data, schedule, trace.key_index, trace.ring_size,
                             draws=draws, seed=trace.seed)
