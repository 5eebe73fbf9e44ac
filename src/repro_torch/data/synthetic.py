"""Deterministic synthetic LM data pipeline.

Seeded, shardable, restart-reproducible: batch ``i`` of host ``h`` is a pure
function of (seed, step, host) — after a checkpoint restart the stream
resumes exactly, and each data-parallel host draws a disjoint slice without
coordination (the property a 1000-node fleet needs from its loader).

The token stream is a mixture of Zipf-distributed unigrams and short copy
motifs so that a language model has learnable structure (quickstart's loss
drops well below ln(V))."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.3
    motif_len: int = 8
    motif_prob: float = 0.5


class SyntheticLM:
    """Iterator of {tokens: (local_batch, T+1)} batches for one host."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0,
                 num_hosts: int = 1, start_step: int = 0):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.step = start_step
        # fixed motif table (shared across hosts; seeded)
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab, size=(64, cfg.motif_len)).astype(np.int32)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, step, self.host_id))

    def next_batch(self) -> dict:
        cfg = self.cfg
        b_loc = cfg.global_batch // self.num_hosts
        rng = self._batch_rng(self.step)
        toks = rng.choice(cfg.vocab, size=(b_loc, cfg.seq_len + 1),
                          p=self._p).astype(np.int32)
        # splice in copy motifs (learnable bigram structure)
        n_splice = int(cfg.seq_len * cfg.motif_prob / cfg.motif_len)
        for b in range(b_loc):
            pos = rng.integers(0, cfg.seq_len - cfg.motif_len,
                               size=n_splice)
            mid = rng.integers(0, len(self._motifs), size=n_splice)
            for p0, m in zip(pos, mid):
                toks[b, p0:p0 + cfg.motif_len] = self._motifs[m]
        self.step += 1
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class FrontendLM(SyntheticLM):
    """``SyntheticLM``'s stream with a frontend's inputs, for a ``vit`` or
    ``encodec`` model (``configs.base.ModelConfig.frontend``): ``vit``
    batches add ``patches`` (local_batch, n_prefix, d_frontend); ``encodec``
    ones are ``frames`` (local_batch, T, d_frontend) with the token stream's
    next-token ``labels`` (local_batch, T).  The frontend inputs are normal
    draws from (seed, step, host), so the stream stays a pure function of
    the step."""

    def __init__(self, model_cfg, cfg: DataConfig, **kw):
        super().__init__(cfg, **kw)
        self.model_cfg = model_cfg

    def next_batch(self) -> dict:
        step = self.step
        out = super().next_batch()
        mc = self.model_cfg
        b_loc, T = out["tokens"].shape[0], self.cfg.seq_len
        rng = np.random.default_rng((self.cfg.seed, step, self.host_id, 1))
        if mc.frontend == "vit":
            out["patches"] = rng.normal(
                size=(b_loc, mc.n_prefix, mc.d_frontend)).astype(np.float32)
        elif mc.frontend == "encodec":
            tokens = out.pop("tokens")
            out["frames"] = rng.normal(
                size=(b_loc, T, mc.d_frontend)).astype(np.float32)
            out["labels"] = tokens[:, 1:]
        return out
