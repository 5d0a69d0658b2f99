"""Continuous-batching GBDT serving engine with multi-version forests
(twin of ``repro.serving.continuous``; the reference's ``backend=`` is the
engine's ``device=``, the card unless one is given).

Replaces the drain-the-queue wave loop with per-arrival admission and
latency-SLO-aware batch cutting (DESIGN.md §17). Three ideas:

- **Continuous batching** — requests are routed to a version's queue the
  moment they arrive; a wave is cut when it FILLS (``max_rows`` queued) or
  when the head-of-line request's deadline budget is spent. The budget is
  ``slo_s`` minus an EWMA estimate of wave compute (floored at a quarter of
  the SLO so a slow wave can't starve cutting entirely): the engine waits
  as long as the SLO allows to pack bigger waves, and no longer.
- **Multi-version forests** — several ``ForestServer`` instances (same bin
  edges and wave geometry, independent forest/checkpoint-root/objective/
  quantization) serve concurrently. Traffic splits by deterministic
  uid-hash over the configured A/B weights; ``PredictRequest.version``
  pins a request to a named version explicitly. **Shadow** versions
  receive a copy of every weighted-routed request but their results are
  diverted to ``shadow_results`` — a candidate forest sees production
  traffic without ever answering it.
- **Per-version everything** — each version carries its own
  ``model_step`` (hot-swap advances them independently), its own
  objective link, and optionally a quantized (int8/fp16) payload; every
  ``PredictResult`` is labeled with the version that computed it.

Thread discipline: the version table, the EWMA, and the result buffers
live under ``_lock``; the per-version queues are the servers' own
``_qlock`` business. The engine lock is never held across a wave compute.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serving.forest_server import ForestServer, PredictRequest, PredictResult

# Knuth multiplicative hash: uid -> uniform [0, 1) for weighted routing.
_HASH_MULT = 2654435761
_HASH_MOD = 2**32


def route_hash(uid: int) -> float:
    """Deterministic uniform-ish routing coordinate for a request uid."""
    return ((uid * _HASH_MULT) & (_HASH_MOD - 1)) / _HASH_MOD


@dataclasses.dataclass
class _Version:
    name: str
    server: ForestServer
    weight: float
    shadow: bool


class ForestEngine:
    """Continuous-batching front end over per-version ``ForestServer``s.

    ``submit`` admits (validates, stamps arrival, routes, enqueues) and
    returns immediately with the routed version name; ``step`` cuts and
    serves any wave whose fill or deadline condition fired; ``run`` is the
    synchronous convenience (submit all, drain, sort by uid);
    ``start``/``stop`` run ``step`` from a daemon thread with results
    accumulating for ``poll``.
    """

    def __init__(
        self,
        bin_edges: torch.Tensor,
        *,
        max_rows: int = 256,
        slo_s: float = 0.05,
        device: str | torch.device | None = None,
        on_nonfinite: str = "reject",
        reload_every_waves: int = 8,
    ):
        if slo_s <= 0:
            raise ValueError("slo_s must be > 0")
        self.device = resolve_device(device)
        self.bin_edges = torch.as_tensor(bin_edges, dtype=torch.float32).to(self.device)
        self.max_rows = max_rows
        self.slo_s = slo_s
        self.on_nonfinite = on_nonfinite
        self.reload_every_waves = reload_every_waves
        self._lock = threading.Lock()
        self._versions: dict[str, _Version] = {}  # guarded-by: self._lock
        self._results: list[PredictResult] = []  # guarded-by: self._lock
        self._shadow_results: list[PredictResult] = []  # guarded-by: self._lock
        # EWMA of observed wave compute seconds — the deadline budget's
        # estimate of "how long will the wave I cut now take".
        self._ewma_compute = 0.0  # guarded-by: self._lock
        self._runner: threading.Thread | None = None
        self._runner_stop: threading.Event | None = None

    # ---------------------------------------------------------------- versions
    def add_version(
        self,
        name: str,
        forest,
        *,
        weight: float = 1.0,
        shadow: bool = False,
        ckpt_root=None,
        model_step: int = -1,
        objective=None,
        quantize: str | None = None,
    ) -> None:
        """Register a named forest version. ``weight`` is its share of
        A/B-routed traffic (ignored for ``shadow`` versions, which copy
        routed traffic instead of receiving a share of it)."""
        if weight < 0:
            raise ValueError("weight must be >= 0")
        server = ForestServer(
            forest,
            self.bin_edges,
            ckpt_root=ckpt_root,
            max_rows=self.max_rows,
            device=self.device,
            model_step=model_step,
            objective=objective,
            on_nonfinite=self.on_nonfinite,
            reload_every_waves=self.reload_every_waves,
            quantize=quantize,
        )
        with self._lock:
            if name in self._versions:
                raise ValueError(f"version {name!r} already registered")
            self._versions[name] = _Version(name, server, weight, shadow)

    def remove_version(self, name: str) -> None:
        with self._lock:
            self._versions.pop(name)

    def set_weight(self, name: str, weight: float) -> None:
        """Reweight A/B routing live (e.g. ramp a canary 1% -> 50%)."""
        if weight < 0:
            raise ValueError("weight must be >= 0")
        with self._lock:
            self._versions[name].weight = weight

    def version_steps(self) -> dict[str, int]:  # concurrent
        """Current ``model_step`` per version (each under its own lock)."""
        with self._lock:
            versions = list(self._versions.values())
        out = {}
        for v in versions:
            with v.server._lock:
                out[v.name] = v.server.model_step
        return out

    # ---------------------------------------------------------------- admission
    def submit(self, req: PredictRequest) -> str:  # concurrent
        """Admit a request NOW (continuous batching: no wave boundary in
        the way). Routes by ``req.version`` if pinned, else by uid-hash
        over the A/B weights; shadow versions get a copy of every
        weighted-routed request. Returns the serving version's name."""
        with self._lock:
            versions = list(self._versions.values())
        if req.version is not None:
            for v in versions:
                if v.name == req.version:
                    v.server.submit(req)
                    return v.name
            raise KeyError(f"unknown forest version {req.version!r}")
        live = [v for v in versions if not v.shadow and v.weight > 0]
        if not live:
            raise RuntimeError("no routable (non-shadow, weight > 0) versions")
        total = sum(v.weight for v in live)
        h = route_hash(req.uid)
        chosen, acc = live[-1], 0.0
        for v in live:
            acc += v.weight / total
            if h < acc:
                chosen = v
                break
        chosen.server.submit(req)
        for v in versions:
            if v.shadow:
                v.server.submit(
                    PredictRequest(uid=req.uid, x=req.x, version=v.name)
                )
        return chosen.name

    # ------------------------------------------------------------------ serving
    def _cut_budget(self) -> float:
        """Seconds a head-of-line request may still wait before its wave
        must be cut: the SLO minus the expected compute of the wave it
        will ride, floored at slo/4 so one slow wave cannot drive the
        budget to zero and thrash single-request waves forever."""
        with self._lock:
            ewma = self._ewma_compute
        return max(self.slo_s - ewma, 0.25 * self.slo_s)

    def step(self, force: bool = False) -> list[PredictResult]:  # concurrent
        """Cut and serve every wave whose condition fired; returns newly
        completed non-shadow results (shadow completions divert to
        ``shadow_results``). With ``force``, drains all queues."""
        with self._lock:
            versions = list(self._versions.values())
        budget = self._cut_budget()
        out: list[PredictResult] = []
        for v in versions:
            while True:
                queued = v.server.queued_rows()
                if not queued:
                    break
                full = queued >= self.max_rows
                due = v.server.oldest_wait() >= budget
                if not (full or due or force):
                    break
                t0 = time.perf_counter()
                res = v.server.serve_next_wave()
                dt = time.perf_counter() - t0
                with self._lock:
                    self._ewma_compute = (
                        dt
                        if self._ewma_compute == 0.0
                        else 0.8 * self._ewma_compute + 0.2 * dt
                    )
                for r in res:
                    r.version = v.name
                if v.shadow:
                    with self._lock:
                        self._shadow_results.extend(res)
                else:
                    out.extend(res)
        return out

    def flush(self) -> list[PredictResult]:
        """Drain every queue regardless of SLO state."""
        return self.step(force=True)

    def run(
        self, requests: Iterable[PredictRequest] | None = None
    ) -> list[PredictResult]:
        """Synchronous convenience: submit, drain, sort by uid."""
        for r in requests or ():
            self.submit(r)
        return sorted(self.flush(), key=lambda r: r.uid)

    # --------------------------------------------------------------- background
    def start(self, interval_s: float = 0.001) -> None:
        """Serve continuously from a daemon thread: ``step`` runs every
        ``interval_s`` so deadline cuts fire without a caller in the loop.
        Completed results accumulate for ``poll``."""
        if self._runner is not None:
            return
        stop = threading.Event()

        def _engine_loop():  # concurrent
            while not stop.wait(interval_s):
                res = self.step()
                if res:
                    with self._lock:
                        self._results.extend(res)

        self._runner_stop = stop
        self._runner = threading.Thread(
            target=_engine_loop, name="forest-engine", daemon=True
        )
        self._runner.start()

    def stop(self, drain: bool = True) -> None:
        if self._runner is None:
            return
        assert self._runner_stop is not None
        self._runner_stop.set()
        self._runner.join()
        self._runner = None
        self._runner_stop = None
        if drain:
            res = self.flush()
            if res:
                with self._lock:
                    self._results.extend(res)

    def poll(self) -> list[PredictResult]:  # concurrent
        """Pop results completed by the background loop since last poll."""
        with self._lock:
            out = list(self._results)
            self._results.clear()
        return out

    @property
    def shadow_results(self) -> list[PredictResult]:
        with self._lock:
            return list(self._shadow_results)


def percentile_latencies(results: Iterable[PredictResult]) -> dict[str, float]:
    """p50/p99 of queue, compute, and end-to-end latency in milliseconds —
    the reporting contract the serving bench gates on."""
    rs = list(results)
    if not rs:
        return {}
    out = {}
    for field in ("queue_s", "compute_s", "latency_s"):
        vals = np.asarray([getattr(r, field) for r in rs], np.float64) * 1e3
        key = field[:-2]
        out[f"{key}_p50_ms"] = float(np.percentile(vals, 50))
        out[f"{key}_p99_ms"] = float(np.percentile(vals, 99))
    return out
