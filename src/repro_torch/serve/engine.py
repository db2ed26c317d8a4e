"""Serving engine with continuous batching over fixed decode slots
(``repro/serve/engine.py``).

The engine owns a (n_slots, max_len) cache; requests are admitted into free
slots, prefilled one at a time into a 1-slot cache whose leaves are then
scattered into the batched cache at the slot index, and decoded jointly
(one batched ``decode_step`` per tick serves every active slot). Finished
slots are recycled at once. The cache's ``pos`` is a shared scalar unless
the caller replaces it with a per-slot (n_slots,) vector on the model's
device, as the tests do; ``_scatter_slot`` documents the scalar's limit.

Each prefill and each tick ends in the host reading the logits, which
waits for the device, so ``prefill_seconds`` and ``tick_seconds`` (host
clock around each call) are device-inclusive times.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 → greedy
    eos_token: int = -1               # -1 → never stops early


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    gen: GenerationConfig = dataclasses.field(default_factory=GenerationConfig)
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    logits: list = dataclasses.field(default_factory=list)  # with keep_logits: f32 rows
    submitted_s: float = 0.0
    finished_s: float = 0.0

    @property
    def done(self) -> bool:
        return self.finished_s > 0


class ServeEngine:
    """Continuous-batching engine around a port ``Model`` (decoder families).

    ``device`` (default: the CUDA device) must be where the model lies.
    ``generator`` (a CPU ``torch.Generator``) draws the samples of requests
    with ``temperature > 0``; its draws differ from ``jax.random``'s.
    ``keep_logits`` keeps each request's f32 logits rows in ``req.logits``.
    """

    def __init__(self, model, n_slots: int = 4, max_len: int = 128, *, device=None,
                 generator: torch.Generator | None = None, keep_logits: bool = False):
        if model.cfg.family == "encdec":
            raise ValueError("encdec serving needs per-request encoder state")
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model lies on {model.device}, the engine runs on {dev}")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.generator = generator
        self.keep_logits = keep_logits
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * n_slots
        self.remaining = np.zeros(n_slots, np.int64)
        self.cache = model.init_cache(n_slots, max_len)
        self.ticks = 0
        self.prefill_seconds: list[float] = []
        self.tick_seconds: list[float] = []

    # ------------------------------------------------------------- lifecycle

    def submit(self, req: Request):
        req.submitted_s = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _admit(self):
        """Prefill queued requests into free slots (single-slot prefill,
        scatter into the batched cache)."""
        for slot in self._free_slots():
            if not self.queue:
                return
            req = self.queue.popleft()
            t0 = time.perf_counter()
            one_cache = self.model.init_cache(1, self.max_len)
            logits, one_cache = self.model.prefill({"tokens": req.prompt[None, :]}, one_cache)
            row = logits[0, -1].float().cpu().numpy()
            self.prefill_seconds.append(time.perf_counter() - t0)
            if self.keep_logits:
                req.logits.append(row)
            req.output.append(int(np.argmax(row)))
            self.cache = _scatter_slot(self.cache, one_cache, slot)
            self.active[slot] = req
            self.remaining[slot] = req.gen.max_new_tokens - 1

    def _retire(self, slot: int):
        req = self.active[slot]
        req.finished_s = time.perf_counter()
        self.active[slot] = None
        self.remaining[slot] = 0

    # ------------------------------------------------------------------ tick

    def step(self) -> int:
        """One engine tick: admit, batched decode, sample, retire. Returns
        number of active requests served this tick."""
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        last_tokens = np.zeros((self.n_slots, 1), np.int64)
        for i in live:
            last_tokens[i, 0] = self.active[i].output[-1]
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(last_tokens, self.cache)
        logits = logits[:, -1].float().cpu().numpy()
        self.tick_seconds.append(time.perf_counter() - t0)
        for i in live:
            req = self.active[i]
            if self.keep_logits:
                req.logits.append(logits[i])
            if req.gen.temperature > 0:
                if self.generator is None:
                    raise ValueError("sampling at temperature > 0 needs a torch.Generator")
                probs = torch.softmax(torch.from_numpy(logits[i]) / req.gen.temperature, -1)
                tok = int(torch.multinomial(probs, 1, generator=self.generator))
            else:
                tok = int(np.argmax(logits[i]))
            req.output.append(tok)
            self.remaining[i] -= 1
            if self.remaining[i] <= 0 or tok == req.gen.eos_token:
                self._retire(i)
        self.ticks += 1
        return len(live)

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        done: list[Request] = []
        while (self.queue or any(r is not None for r in self.active)) and self.ticks < max_ticks:
            before = list(self.active)
            self.step()
            for r in before:
                if r is not None and r.done and r not in done:
                    done.append(r)
        return done


def _scatter_slot(batched_cache: dict, one_cache: dict, slot: int) -> dict:
    """Write a 1-slot cache into slot `slot` of the batched cache (in place),
    leaf by leaf through nested dicts (the hybrid's groups and tail).

    Layout contract: leaves with a leading layer axis carry batch at axis 1;
    unstacked leaves (hybrid tail blocks) carry batch at axis 0; scalar 'pos' merges by max
    (per-slot positions tracked host-side; correctness for mixed-length
    decode comes from each slot's own attention mask built from cache
    contents — valid because shorter slots' future lanes hold zeros and are
    masked by position ≥ written range only for ring caches; for linear
    caches the shared pos must be the per-slot max, so admission order should
    keep prompt lengths similar for exactness — documented engine limit).
    """
    out = dict(batched_cache)
    for key, o in one_cache.items():
        b = batched_cache[key]
        if isinstance(o, dict):
            out[key] = _scatter_slot(b, o, slot)
        elif o.ndim == 0:  # 'pos' from the 1-slot cache
            if b.ndim == 0:
                out[key] = torch.maximum(b, o)  # legacy shared-scalar pos
            else:
                b[slot] = o.to(device=b.device, dtype=b.dtype)  # per-slot position vector
        elif b.ndim >= 2 and o.ndim == b.ndim and o.shape[0] == b.shape[0] and o.shape[1] == 1:
            b[:, slot:slot + 1] = o.to(b.dtype)  # layer-stacked (L, B, ...) leaf
        else:
            b[slot:slot + 1] = o.to(b.dtype)  # unstacked (B, ...) leaf
    return out
