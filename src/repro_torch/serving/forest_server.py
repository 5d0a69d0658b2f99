"""GBDT forest serving: raw-float requests -> binned -> traversal kernel.

Twin of ``repro.serving.forest_server``:

- **Forests** — f32 or quantized (``quantize='int8'|'fp16'`` packs the
  installed forest with ``Forest.quantize``; a ``QuantizedForest`` is kept
  whole), one output or K (an objective's ``n_outputs`` must match).
- **Wave batching** — variable-size requests are packed row-wise into
  waves of ``max_rows`` rows, padded to one static (max_rows, F) shape.
  Requests larger than ``max_rows`` are split into parts and reassembled
  under their uid; callers never see the wave geometry.
- **Serve-time binning** — requests carry raw floats; the predict applies
  the training-time edges (``apply_bins``) on the card before traversal.
- **Hot swap** — with ``ckpt_root``, ``maybe_reload`` loads the newest
  checkpointed forest (``load_forest_checkpoint``, TrainState or bare
  Forest) and swaps it in; the serving path calls it every
  ``reload_every_waves`` waves, and ``start_reload_poller`` bounds the lag
  in wall-clock time for idle servers. Reloads re-pack with ``quantize``.
- **Non-finite input** — ``on_nonfinite='reject'`` refuses a request with
  NaN/±inf in ``submit``; ``'flag'`` serves it (±inf clamp, NaN to bin 0)
  and reports the offending rows in ``PredictResult.nonfinite_rows``.

Thread discipline: the served forest, ``model_step`` and the wave count
live under ``_lock``; the part queue and reassembly state under
``_qlock``. The two are never held together.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import threading
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch import checkpoint, resolve_device
from repro_torch.objectives import Objective, get_objective
from repro_torch.trees.binning import apply_bins
from repro_torch.trees.forest import Forest, QuantizedForest, forest_predict


_FOREST_FIELDS = ("feature", "threshold", "leaf_value", "n_trees", "base_score")


def _nonfinite_rows(x: np.ndarray) -> np.ndarray:
    """Indices of rows containing any NaN/±inf feature."""
    return np.flatnonzero(~np.isfinite(x).all(axis=1))


def load_forest_checkpoint(
    root: str | pathlib.Path, step: int, like: Forest | QuantizedForest | None = None,
    *, device: str | torch.device | None = None,
) -> Forest:
    """The f32 ``Forest`` of a checkpoint written by a training loop, on
    ``device`` (the card unless one is given).

    Reads bare-``Forest`` checkpoints (leaf paths ``.feature`` ...) and
    ``TrainState`` ones (``.forest/.feature`` ...) alike, matching leaves by
    their trailing field, so the server never loads the training-set-sized
    ``f``. Where several leaves end in one field, the one under a
    ``forest`` parent wins; anything still ambiguous raises. With ``like``
    the shapes are checked against the serving template. The copies to the
    device are blocking: the forest is whole on the device on return.
    """
    dev = resolve_device(device)
    d = checkpoint.step_dir(root, step)
    manifest = json.loads((d / "manifest.json").read_text())
    candidates: dict[str, list[tuple[list[str], dict]]] = {f: [] for f in _FOREST_FIELDS}
    for entry in manifest["leaves"]:
        # ".forest" for attributes, "['forest']" for dict keys: strip both.
        segs = [s.strip(".[]'\"") for s in entry["path"].split("/")]
        if segs[-1] in candidates:
            candidates[segs[-1]].append((segs, entry))
    found: dict[str, np.ndarray] = {}
    for field, cands in candidates.items():
        if len(cands) > 1:
            preferred = [c for c in cands if len(c[0]) > 1 and c[0][-2] == "forest"]
            if len(preferred) != 1:
                paths = sorted(e["path"] for _, e in cands)
                raise KeyError(
                    f"checkpoint {d}: forest leaf {field!r} is ambiguous — {len(cands)} "
                    f"leaves end in it ({paths}) and "
                    f"{'none' if not preferred else 'several'} sit under a 'forest' parent"
                )
            cands = preferred
        if cands:
            found[field] = np.load(d / cands[0][1]["file"])
    missing = [f for f in _FOREST_FIELDS if f not in found]
    if missing:
        raise KeyError(f"checkpoint {d} has no forest leaves {missing}")
    dtypes = (torch.int32, torch.int32, torch.float32, torch.int32, torch.float32)
    forest = Forest(*(torch.as_tensor(found[f]).to(device=dev, dtype=t)
                      for f, t in zip(_FOREST_FIELDS, dtypes)))
    if like is not None:
        for name in ("feature", "threshold", "leaf_value", "base_score"):
            got, want = tuple(getattr(forest, name).shape), tuple(getattr(like, name).shape)
            if got != want:
                raise ValueError(f"{name}: checkpoint shape {got} != serving template {want}")
    return forest


@dataclasses.dataclass
class PredictRequest:
    uid: int
    x: np.ndarray  # (n, F) float32 raw feature rows
    # Pins the request to a named forest version of a ``ForestEngine``;
    # None lets the engine's A/B weights route it.
    version: str | None = None


@dataclasses.dataclass
class PredictResult:
    uid: int
    scores: np.ndarray  # (n,) or (n, K) raw margins, or linked with an objective
    model_step: int  # checkpoint step of the forest that served the request
    latency_s: float  # queue_s + compute_s
    queue_s: float = 0.0  # arrival -> first part starts computing
    compute_s: float = 0.0  # summed wave compute across this uid's parts
    version: str | None = None  # the engine's version that served it
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
    """Wave-batched GBDT inference with checkpoint hot swap, on the card (or
    on ``device``).

    ``forest`` and ``bin_edges`` (the training-time quantile edges) move to
    the server's device; the forest's shapes are the template a reloaded
    checkpoint must match. With ``objective``, its ``link`` is applied to
    the served scores (for ``"multiclass:K"``, (rows, K) softmax rows);
    without it raw F(x) margins are served. With ``quantize`` ('int8' or
    'fp16') the installed forest, and every reloaded one, is packed by
    ``Forest.quantize``; scores then stay within
    ``trees.forest.quantization_atol`` of the f32 forest's. With
    ``ckpt_root``, ``maybe_reload`` swaps in newer checkpointed forests;
    waves call it every ``reload_every_waves`` waves.
    """

    def __init__(
        self,
        forest: Forest | QuantizedForest,
        bin_edges: torch.Tensor,
        *,
        ckpt_root: str | pathlib.Path | None = None,
        max_rows: int = 256,
        model_step: int = -1,
        objective: Objective | str | None = None,
        on_nonfinite: str = "reject",
        reload_every_waves: int = 8,
        device: str | torch.device | None = None,
        quantize: str | None = None,
    ):
        if on_nonfinite not in ("reject", "flag"):
            raise ValueError(
                f"on_nonfinite must be 'reject' or 'flag', got {on_nonfinite!r}"
            )
        if reload_every_waves < 1:
            raise ValueError("reload_every_waves must be >= 1")
        self.device = resolve_device(device)
        # The hot-swap pair (forest, model_step) moves together under
        # _lock: a wave never sees one forest labelled with another's step.
        self._lock = threading.Lock()  # forest + model_step + waves_served
        self._qlock = threading.Lock()  # part queue + reassembly state
        forest = type(forest)(*(t.to(self.device) for t in forest))
        if quantize is not None and isinstance(forest, QuantizedForest):
            raise ValueError("quantize= packs an f32 Forest; this forest is already "
                             f"quantized ({forest.mode})")
        self._template = forest  # shapes a reloaded checkpoint must match
        self._quantize = quantize
        if quantize is not None:
            forest = forest.quantize(quantize)
        self.forest = forest  # guarded-by: self._lock
        self.model_step = model_step  # guarded-by: self._lock
        self.waves_served = 0  # guarded-by: self._lock
        self.bin_edges = torch.as_tensor(bin_edges, dtype=torch.float32).to(self.device)
        self.ckpt_root = ckpt_root
        self.max_rows = max_rows
        self.on_nonfinite = on_nonfinite
        self.reload_every_waves = reload_every_waves
        self.objective = get_objective(objective) if objective is not None else None
        if self.objective is not None and self.objective.n_outputs != forest.n_outputs:
            # A mismatched link would normalize across the wave (softmax over
            # a (rows,) vector) instead of within each row.
            raise ValueError(
                f"objective {self.objective.name!r} has {self.objective.n_outputs} outputs "
                f"but the forest serves {forest.n_outputs}"
            )
        self._queue: collections.deque[_Part] = collections.deque()  # guarded-by: self._qlock
        self._poller: threading.Thread | None = None
        self._poll_stop: threading.Event | None = None

    def _predict(self, forest: Forest | QuantizedForest, x: np.ndarray) -> np.ndarray:
        """link(base + traverse(apply_bins(x))) on the server's device."""
        bins = apply_bins(torch.from_numpy(x).to(self.device), self.bin_edges)
        raw = forest_predict(forest, bins)
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

    def oldest_wait(self, now: float | None = None) -> float:  # concurrent
        """Seconds the head-of-line request has waited; 0.0 when idle (the
        engine cuts a wave when this nears its latency budget)."""
        if now is None:
            now = time.perf_counter()
        with self._qlock:
            return now - self._queue[0].asm.arrival_s if self._queue else 0.0

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
        # One snapshot of the swap pair: every result of this wave carries
        # the step of the forest that computed it, even if a poller swaps
        # mid-wave.
        with self._lock:
            forest, model_step = self.forest, self.model_step
        t0 = time.perf_counter()
        scores = self._predict(forest, rows)  # returns once the card is done
        dt = time.perf_counter() - t0
        with self._lock:
            self.waves_served += 1
            waves = self.waves_served
        results, off = [], 0
        for part, n in zip(wave, sizes):
            asm = part.asm
            with self._qlock:
                if asm.scores is None:
                    asm.scores = np.zeros((asm.x.shape[0],) + scores.shape[1:],
                                          scores.dtype)
                if asm.queue_s < 0:
                    asm.queue_s = t0 - asm.arrival_s
                asm.scores[part.lo : part.hi] = scores[off : off + n]
                asm.compute_s += dt
                # The newest forest any of the request's parts saw.
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
        if waves % self.reload_every_waves == 0:
            # Bounded lag: a busy server is never more than
            # reload_every_waves waves behind the newest checkpoint.
            self.maybe_reload()
        return results

    def maybe_reload(self) -> bool:  # concurrent
        """Swap in the newest checkpointed forest, if newer than the one
        served. Safe from a poller thread: the checkpoint is loaded (and
        packed) outside the lock, whole on the device before it is
        published, then installed by compare-and-swap with its step, so a
        racing reloader that installed this step or a newer one wins."""
        if self.ckpt_root is None:
            return False
        step = checkpoint.latest_step(self.ckpt_root)
        with self._lock:
            current = self.model_step
        if step is None or step <= current:
            return False
        forest = load_forest_checkpoint(self.ckpt_root, step, like=self._template,
                                        device=self.device)
        if self._quantize:
            forest = forest.quantize(self._quantize)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            if step <= self.model_step:
                return False
            self.forest, self.model_step = forest, step
        return True

    def start_reload_poller(self, interval_s: float = 0.05) -> None:
        """Poll the checkpoint root every ``interval_s`` from a daemon
        thread, so an idle server's swap lag is bounded in time too."""
        if self._poller is not None:
            return
        stop = threading.Event()

        def _poll():  # concurrent
            while not stop.wait(interval_s):
                self.maybe_reload()

        self._poll_stop = stop
        self._poller = threading.Thread(target=_poll, name="forest-reload-poller",
                                        daemon=True)
        self._poller.start()

    def stop_reload_poller(self) -> None:
        if self._poller is None:
            return
        self._poll_stop.set()
        self._poller.join()
        self._poller = self._poll_stop = None

    def run(self, requests: Iterable[PredictRequest] | None = None) -> list[PredictResult]:
        """Submit ``requests`` and serve waves until the queue is drained,
        checking for a newer checkpoint before each wave."""
        for r in requests or ():
            self.submit(r)
        done: list[PredictResult] = []
        while True:
            self.maybe_reload()
            wave = self._next_wave()
            if not wave:
                break  # parts never exceed max_rows: an empty wave means drained
            done.extend(self._run_wave(wave))
        return sorted(done, key=lambda r: r.uid)
