"""Continuous / in-flight batching over heterogeneous sequence lengths.

The scheduler owns a fixed array of ``slots`` decode lanes.  Each step it

1. **refills** finished slots: drains a length-bucketed group from the
   :class:`repro_torch.serving.queue.RequestQueue`, prefills the group's
   prompts in one padded batch (prefill attention through the Hopper
   flash-attention kernel on the card), and *admits* the resulting
   per-request caches into the KV pages (a ``SharedWindow`` store epoch —
   the pages are unreadable until the fence closes it);
2. runs **one decode step over the whole batch** with a per-slot position
   vector (heterogeneous lengths decode together — no lane waits for its
   neighbours), commits + fences the updated cache;
3. **samples** the next token per active slot host-side and retires slots
   whose budget is spent.

Prefill admission protocol: prefill consumes ``prompt[:-1]``; a slot is
admitted with ``(next_token, pos) = (prompt[-1], T0 - 1)``, so its first
decode step re-feeds the last prompt token and produces the logits for the
first generated token.  Prompts are right-padded to the group's bucket on
pure global-attention models: a padded KV position is only attendable once
``pos`` has passed it, by which point the decode loop has overwritten it
(write-before-read induction) — recurrent / sliding-window models use
exact-length buckets instead, because padded prefill steps would corrupt
carried state.

Sampling is keyed per request and per token index — a ``torch.Generator``
seeded from ``(seed, rid, tok_idx)`` — never per slot or per step, so the
token stream of a request is independent of which slot it lands in and of
its batch neighbours.  (It cannot reproduce ``jax.random``'s draws.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serving.engine import GenResult, materialize_params
from repro_torch.serving.kv_cache import KVCachePages, _leaves
from repro_torch.serving.queue import Request, RequestQueue, bucket_len

DecodeFn = Callable[..., tuple]


def _bucket_mode(cfg) -> str:
    kinds = set(cfg.pattern) | set(cfg.remainder_kinds)
    return "pow2" if kinds <= {"attn"} and cfg.window is None else "exact"


@dataclasses.dataclass
class StepStats:
    """Telemetry for one scheduler step (``prefill_us`` / ``bucket``: the
    refill's prefill, when this step admitted a group)."""

    decode_us: float
    active: int
    admitted: int
    finished: int
    prefill_us: float = 0.0
    bucket: int = -1


class ContinuousBatchingScheduler:
    """Fixed-slot continuous batching engine (single-device decode).

    ``decode_fn`` defaults to ``model.decode_fn``; any callable with its
    signature may stand in.  ``tuner`` (a
    :class:`repro_torch.serving.live_tuning.LiveTuner`) receives each
    decode step's latency keyed by the decode batch signature."""

    def __init__(self, model, params, *, slots: int, s_max: int,
                 temperature: float = 0.0, seed: int = 0,
                 queue: Optional[RequestQueue] = None,
                 decode_fn: Optional[DecodeFn] = None,
                 tuner=None):
        if slots < 1:
            raise ValueError("need at least one slot")
        self.model = model
        self.params = materialize_params(params)
        self.slots = slots
        self.s_max = s_max
        self.temperature = temperature
        self.seed = seed
        self.queue = queue if queue is not None else RequestQueue()
        self.tuner = tuner
        self.bucket_mode = _bucket_mode(model.cfg)
        self.pages = KVCachePages.for_model(model, slots, s_max)
        self._decode = decode_fn if decode_fn is not None \
            else model.decode_fn
        # live-tuning feed: decode-step latencies land in the same
        # (family="serving", topo, dtype, size-bucket) cells the serving
        # bench family keys — the topology of the model's communicator (a
        # single rank without one), nbytes the model's parameter byte count
        # in f32, the scheme label the decode path this engine runs
        # (``recorded`` for a decoder with ``set_table``)
        comm = model.ctx.comm
        self._tuner_key = dict(
            pods=(comm.pods if comm is not None and comm.pods else 1),
            chips=(comm.chips if comm is not None and comm.chips else 1),
            nbytes=4 * sum(t.numel() for t in _leaves(self.params)),
            scheme=("recorded" if hasattr(self._decode, "set_table")
                    else "sync"))

        # host-side slot map
        self.active = np.zeros(slots, bool)
        self.pos = np.zeros(slots, np.int32)
        self.next_tok = np.zeros(slots, np.int32)
        self.remaining = np.zeros(slots, np.int32)
        self.rid = np.full(slots, -1, np.int64)
        self.emitted = np.zeros(slots, np.int32)
        self._bufs: dict[int, tuple[list, list]] = {}   # rid -> (toks, lps)
        self.results: dict[int, GenResult] = {}
        self.stats: list[StepStats] = []

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # -- admission -----------------------------------------------------------
    def _admit(self, group: list[Request]) -> tuple[float, int]:
        """Prefill ``group`` into free slots; returns (prefill us, bucket)."""
        n = len(group)
        tb = bucket_len(group[0].prompt.size - 1, self.bucket_mode)
        t0 = time.perf_counter()
        if tb > 0:
            toks = np.zeros((n, tb + 1), np.int32)
            for i, req in enumerate(group):
                toks[i, :req.prompt.size - 1] = req.prompt[:-1]
            sub_cache, _ = self.model.prefill_fn(
                self.params,
                {"tokens": torch.from_numpy(toks).to(self.model.device)},
                self.s_max)
        else:
            sub_cache = self.model.cache_init(n, self.s_max)
        idx = np.flatnonzero(~self.active)[:n]
        self.pages = self.pages.admit(idx, sub_cache).fence()
        self._sync()
        prefill_us = (time.perf_counter() - t0) * 1e6
        for slot, req in zip(idx, group):
            self.active[slot] = True
            self.pos[slot] = req.prompt.size - 1
            self.next_tok[slot] = req.prompt[-1]
            self.remaining[slot] = req.max_new
            self.rid[slot] = req.rid
            self.emitted[slot] = 0
            self._bufs[req.rid] = ([], [])
        return prefill_us, tb

    # -- sampling ------------------------------------------------------------
    def _sample(self, lp_row: np.ndarray, rid: int, tok_idx: int) -> int:
        if self.temperature <= 0:
            return int(np.argmax(lp_row))
        key = np.random.SeedSequence([self.seed, rid, tok_idx])
        gen = torch.Generator().manual_seed(int(key.generate_state(1)[0]))
        probs = torch.softmax(torch.from_numpy(lp_row) / self.temperature,
                              dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    # -- the step ------------------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration.  Returns False when fully idle."""
        admitted, prefill_us, bucket = 0, 0.0, -1
        free = int(np.sum(~self.active))
        if free and len(self.queue):
            group = self.queue.take_group(free, bucket=self.bucket_mode)
            if group:
                prefill_us, bucket = self._admit(group)
                admitted = len(group)
        if not self.active.any():
            return False

        dev = self.model.device
        cache = self.pages.cache
        tok = torch.from_numpy(self.next_tok[:, None].copy()).to(dev)
        posv = torch.from_numpy(self.pos.copy()).to(dev)
        t0 = time.perf_counter()
        new_cache, logits = self._decode(self.params, cache, tok, posv)
        lp = torch.log_softmax(logits[:, -1].float(), dim=-1).cpu().numpy()
        decode_us = (time.perf_counter() - t0) * 1e6
        if self.tuner is not None:
            self.tuner.observe("serving", us=decode_us, **self._tuner_key)
        self.pages = self.pages.commit(new_cache).fence()

        finished = 0
        for slot in np.flatnonzero(self.active):
            rid = int(self.rid[slot])
            tok_i = self._sample(lp[slot], rid, int(self.emitted[slot]))
            toks, lps = self._bufs[rid]
            toks.append(tok_i)
            lps.append(float(lp[slot, tok_i]))
            self.next_tok[slot] = tok_i
            self.pos[slot] += 1
            self.emitted[slot] += 1
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0 or self.pos[slot] >= self.s_max:
                self.results[rid] = GenResult(
                    tokens=np.asarray([toks], np.int32),
                    logprobs=np.asarray([lps], np.float32))
                del self._bufs[rid]
                self.active[slot] = False
                self.rid[slot] = -1
                finished += 1

        self.stats.append(StepStats(decode_us=decode_us,
                                    active=int(self.active.sum()),
                                    admitted=admitted, finished=finished,
                                    prefill_us=prefill_us, bucket=bucket))
        return True

    def run(self, *, max_steps: Optional[int] = None) -> dict[int, GenResult]:
        """Drive steps until queue + slots drain (or ``max_steps``)."""
        steps = 0
        while max_steps is None or steps < max_steps:
            busy = self.step()
            steps += 1
            if not busy and not len(self.queue):
                break
        return self.results


def generate(model, params, prompts, *, max_new: int, slots: int = 4,
             s_max: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0, decode_fn: Optional[DecodeFn] = None
             ) -> GenResult:
    """Batch-generate via the continuous-batching scheduler.

    ``prompts`` is a list of 1-D int32 arrays (heterogeneous lengths are
    fine).  Returns tokens/logprobs stacked in request order — drop-in for
    ``greedy_generate`` on same-length prompts."""
    prompts = [np.asarray(p, np.int32) for p in prompts]
    s_max = s_max or (max(p.size for p in prompts) + max_new)
    sched = ContinuousBatchingScheduler(
        model, params, slots=min(slots, len(prompts)), s_max=s_max,
        temperature=temperature, seed=seed, decode_fn=decode_fn)
    rids = [sched.queue.submit(p, max_new) for p in prompts]
    results = sched.run()
    return GenResult(
        tokens=np.concatenate([results[r].tokens for r in rids], axis=0),
        logprobs=np.concatenate([results[r].logprobs for r in rids], axis=0))
