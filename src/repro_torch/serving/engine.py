"""Batched serving engine: request queue -> same-length waves -> greedy decode
(twin of ``repro.serving.engine``, for every family of the LM zoo).

Requests are bucketed by prompt length, packed into waves of ``slots``
sequences (a short wave is padded with its last prompt), prefilled once,
then decoded together against the ring cache until every sequence hits EOS
or its token budget. Positions are shared by a wave (the cache carries
one ``pos``), which is the same-length-bucket contract. The VLM and audio
families read each request's ``media`` (M, D): a request without media,
and each pad slot, gets zeros; the wave's media are cast to ``cfg.dtype``.
The recurrent families (hybrid, xLSTM) refuse at ``submit`` a prompt that
does not divide into chunks of ``min(ssm_chunk, P)`` (the reference's
chunk scans assert it), rather than pad it.

On a mesh (``mesh=``, a ``launch.mesh.make_lm_mesh`` grid or the host
mesh) every rank runs the engine on the same requests with its shards of
the parameters (placed by ``specs``, ``param_specs(cfg, mesh)`` if None):
the prefill cuts a wave's rows over ``sharding.batch_axes(mesh)`` and
every rank gets the whole wave's tokens back, so every rank's answers
are the same (``launch.steps``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.cache import require_ported, torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import chunk_of
from repro_torch.sharding import batch_axes


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 32
    media: np.ndarray | None = None  # (M, D) frontend embeddings (VLM, audio)


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray  # generated ids (<= max_new_tokens)
    prefill_s: float  # the wave's prefill, device work included
    decode_s: float  # the wave's decode loop, device work included


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        slots: int = 4,
        max_len: int = 512,
        eos_id: int | None = None,
        device: str | torch.device | None = None,
        mesh=None,
        specs: dict | None = None,
    ):
        require_ported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"parameters lie on {params['embed'].device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.mesh = mesh
        baxes = batch_axes(mesh) if mesh is not None else ()
        self._prefill = make_prefill_step(cfg, mesh, baxes, max_len=max_len, specs=specs)
        self._decode = make_decode_step(cfg, mesh, baxes, specs=specs)
        self._queue: collections.deque[Request] = collections.deque()

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt+budget exceeds max_len={self.max_len}"
            )
        if self.cfg.family in ("hybrid", "ssm"):
            try:
                chunk_of(len(req.prompt), self.cfg.ssm_chunk)
            except ValueError as e:
                raise ValueError(f"request {req.uid}: {e}") from None
        self._queue.append(req)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ waves
    def _next_wave(self) -> list[Request]:
        """Pop up to ``slots`` queued requests sharing one prompt length."""
        if not self._queue:
            return []
        plen = len(self._queue[0].prompt)
        wave, rest = [], collections.deque()
        while self._queue:
            r = self._queue.popleft()
            if len(r.prompt) == plen and len(wave) < self.slots:
                wave.append(r)
            else:
                rest.append(r)
        self._queue = rest
        return wave

    def _run_wave(self, wave: list[Request]) -> list[Completion]:
        n = len(wave)
        pad = self.slots - n
        prompts = np.stack([r.prompt for r in wave] + [wave[-1].prompt] * pad)
        batch = {"tokens": torch.as_tensor(prompts.astype(np.int32), device=self.device)}
        cfg = self.cfg
        if cfg.family in ("vlm", "audio"):
            zero = np.zeros((cfg.n_media_tokens, cfg.d_model), np.float32)
            media = [zero if r.media is None else r.media for r in wave] + [zero] * pad
            batch["media"] = torch.as_tensor(np.stack(media), device=self.device).to(
                torch_dtype(cfg))

        self._sync()
        t0 = time.perf_counter()
        tok, _, cache = self._prefill(self.params, batch)
        self._sync()
        t1 = time.perf_counter()

        budget = max(r.max_new_tokens for r in wave)
        outs = [tok]
        done = np.zeros(self.slots, bool)
        cur = tok[:, None]
        steps = 1
        while steps < budget and not done[:n].all():
            cur_tok, cache = self._decode(self.params, cur, cache)
            outs.append(cur_tok)
            if self.eos_id is not None:
                done |= cur_tok.cpu().numpy() == self.eos_id
            cur = cur_tok[:, None]
            steps += 1
        self._sync()
        t2 = time.perf_counter()

        gen = torch.stack(outs, dim=1).cpu().numpy()  # (slots, T)
        results = []
        for i, r in enumerate(wave):
            toks = gen[i, : r.max_new_tokens]
            if self.eos_id is not None:
                hits = np.nonzero(toks == self.eos_id)[0]
                if hits.size:
                    toks = toks[: hits[0] + 1]
            results.append(Completion(r.uid, toks, prefill_s=t1 - t0, decode_s=t2 - t1))
        return results

    def run(self, requests: Iterable[Request] | None = None) -> list[Completion]:
        for r in requests or ():
            self.submit(r)
        done: list[Completion] = []
        while self._queue:
            wave = self._next_wave()
            if not wave:
                break
            done.extend(self._run_wave(wave))
        return sorted(done, key=lambda c: c.uid)
