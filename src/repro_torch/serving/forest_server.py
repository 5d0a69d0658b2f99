"""GBDT forest serving: raw-float requests -> binned -> traversal kernel.

Twin of ``repro.serving.forest_server`` without the checkpoint hot swap:

- **Wave batching** — variable-size requests are packed row-wise into
  waves of ``max_rows`` rows, padded to one static (max_rows, F) shape.
  Requests larger than ``max_rows`` are split into parts and reassembled
  under their uid; callers never see the wave geometry.
- **Serve-time binning** — requests carry raw floats; the predict applies
  the training-time edges (``apply_bins``) on the card before traversal.
- **Non-finite input** — ``on_nonfinite='reject'`` refuses a request with
  NaN/±inf in ``submit``; ``'flag'`` serves it (±inf clamp, NaN to bin 0)
  and reports the offending rows in ``PredictResult.nonfinite_rows``.

Thread discipline: the served forest and ``model_step`` live under
``_lock``; the part queue and reassembly state under ``_qlock``. The two
are never held together.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.objectives import Objective, get_objective
from repro_torch.trees.binning import apply_bins
from repro_torch.trees.forest import Forest


def _nonfinite_rows(x: np.ndarray) -> np.ndarray:
    """Indices of rows containing any NaN/±inf feature."""
    return np.flatnonzero(~np.isfinite(x).all(axis=1))


@dataclasses.dataclass
class PredictRequest:
    uid: int
    x: np.ndarray  # (n, F) float32 raw feature rows


@dataclasses.dataclass
class PredictResult:
    uid: int
    scores: np.ndarray  # (n,) raw margins, or linked predictions with an objective
    model_step: int
    latency_s: float  # queue_s + compute_s
    queue_s: float = 0.0  # arrival -> first part starts computing
    compute_s: float = 0.0  # summed wave compute across this uid's parts
    nonfinite_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )


@dataclasses.dataclass
class _Assembly:
    """Per-request reassembly state; mutated only under ``_qlock``."""

    req: PredictRequest
    x: np.ndarray  # validated float32 copy of req.x
    arrival_s: float
    parts_left: int
    scores: np.ndarray | None = None
    model_step: int = -1
    queue_s: float = -1.0  # < 0 until the first part starts computing
    compute_s: float = 0.0


@dataclasses.dataclass
class _Part:
    asm: _Assembly
    lo: int  # row slice [lo, hi) of asm.x
    hi: int


class ForestServer:
    """Wave-batched GBDT inference on the card (or on ``device``).

    ``forest`` and ``bin_edges`` (the training-time quantile edges) move to
    the server's device. With ``objective``, its ``link`` is applied to the
    served scores; without it raw F(x) margins are served.
    """

    def __init__(
        self,
        forest: Forest,
        bin_edges: torch.Tensor,
        *,
        max_rows: int = 256,
        model_step: int = -1,
        objective: Objective | str | None = None,
        on_nonfinite: str = "reject",
        device: str | torch.device | None = None,
    ):
        if on_nonfinite not in ("reject", "flag"):
            raise ValueError(
                f"on_nonfinite must be 'reject' or 'flag', got {on_nonfinite!r}"
            )
        self.device = resolve_device(device)
        self._lock = threading.Lock()  # forest + model_step + waves_served
        self._qlock = threading.Lock()  # part queue + reassembly state
        self.forest = Forest(*(t.to(self.device) for t in forest))  # guarded-by: self._lock
        self.model_step = model_step  # guarded-by: self._lock
        self.waves_served = 0  # guarded-by: self._lock
        self.bin_edges = torch.as_tensor(bin_edges, dtype=torch.float32).to(self.device)
        self.max_rows = max_rows
        self.on_nonfinite = on_nonfinite
        self.objective = get_objective(objective) if objective is not None else None
        self._queue: collections.deque[_Part] = collections.deque()  # guarded-by: self._qlock

    def _predict(self, forest: Forest, x: np.ndarray) -> np.ndarray:
        """link(base + traverse(apply_bins(x))) on the server's device."""
        bins = apply_bins(torch.from_numpy(x).to(self.device), self.bin_edges)
        raw = forest.base_score + ops.forest_traverse(
            bins, forest.feature, forest.threshold, forest.leaf_value,
            forest.n_trees, forest.depth,
        )
        out = raw if self.objective is None else self.objective.link(raw)
        return out.cpu().numpy()

    def submit(self, req: PredictRequest) -> None:  # concurrent
        """Validate and enqueue, split into ``max_rows`` parts. Arrival is
        stamped now, so ``queue_s`` counts every second behind earlier
        traffic."""
        n_feat = self.bin_edges.shape[0]
        x = np.asarray(req.x, np.float32)
        if x.ndim != 2 or x.shape[1] != n_feat:
            raise ValueError(
                f"request {req.uid}: expected (n, {n_feat}) features, got {x.shape}"
            )
        bad = _nonfinite_rows(x)
        if bad.size and self.on_nonfinite == "reject":
            raise ValueError(
                f"request {req.uid}: non-finite features in rows {bad.tolist()} "
                "(server runs on_nonfinite='reject'; use 'flag' to serve them)"
            )
        n = x.shape[0]
        cuts = list(range(0, n, self.max_rows)) or [0]
        asm = _Assembly(req=req, x=x, arrival_s=time.perf_counter(), parts_left=len(cuts))
        # All parts land under one lock acquisition: a draining wave never
        # sees half a request.
        with self._qlock:
            for lo in cuts:
                self._queue.append(_Part(asm, lo, min(lo + self.max_rows, n)))

    def queued_rows(self) -> int:  # concurrent
        """Rows currently waiting to be served."""
        with self._qlock:
            return sum(p.hi - p.lo for p in self._queue)

    def _next_wave(self) -> list[_Part]:  # concurrent
        """Pop queued parts while their rows fit in one ``max_rows`` wave."""
        with self._qlock:
            wave, rows = [], 0
            while self._queue and rows + (
                self._queue[0].hi - self._queue[0].lo
            ) <= self.max_rows:
                part = self._queue.popleft()
                wave.append(part)
                rows += part.hi - part.lo
            return wave

    def serve_next_wave(self) -> list[PredictResult]:  # concurrent
        """Cut and serve one wave; returns the requests whose last part rode it."""
        wave = self._next_wave()
        return self._run_wave(wave) if wave else []

    def _run_wave(self, wave: list[_Part]) -> list[PredictResult]:  # concurrent
        sizes = [p.hi - p.lo for p in wave]
        rows = np.zeros((self.max_rows, self.bin_edges.shape[0]), np.float32)
        if sum(sizes):
            rows[: sum(sizes)] = np.concatenate([p.asm.x[p.lo : p.hi] for p in wave])
        with self._lock:
            forest, model_step = self.forest, self.model_step
        t0 = time.perf_counter()
        scores = self._predict(forest, rows)  # returns once the card is done
        dt = time.perf_counter() - t0
        with self._lock:
            self.waves_served += 1
        results, off = [], 0
        for part, n in zip(wave, sizes):
            asm = part.asm
            with self._qlock:
                if asm.scores is None:
                    asm.scores = np.zeros((asm.x.shape[0],), scores.dtype)
                if asm.queue_s < 0:
                    asm.queue_s = t0 - asm.arrival_s
                asm.scores[part.lo : part.hi] = scores[off : off + n]
                asm.compute_s += dt
                asm.model_step = max(asm.model_step, model_step)
                asm.parts_left -= 1
                if asm.parts_left == 0:
                    results.append(PredictResult(
                        uid=asm.req.uid,
                        scores=asm.scores,
                        model_step=asm.model_step,
                        latency_s=asm.queue_s + asm.compute_s,
                        queue_s=asm.queue_s,
                        compute_s=asm.compute_s,
                        nonfinite_rows=_nonfinite_rows(asm.x),
                    ))
            off += n
        return results

    def run(self, requests: Iterable[PredictRequest] | None = None) -> list[PredictResult]:
        """Submit ``requests`` and serve waves until the queue is drained."""
        for r in requests or ():
            self.submit(r)
        done: list[PredictResult] = []
        while True:
            wave = self._next_wave()
            if not wave:
                break  # parts never exceed max_rows: an empty wave means drained
            done.extend(self._run_wave(wave))
        return sorted(done, key=lambda r: r.uid)
