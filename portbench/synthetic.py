"""The training traffic: a seeded synthetic token stream.

A frozen copy of the port's ``data/synthetic.py::SyntheticLM``, so that the
yardstick's traffic cannot move with the program.  Batch ``i`` is a pure
function of (seed, i): Zipf-distributed unigrams with short copy motifs
spliced in, so every row differs and a language model has structure to
learn.
"""

from __future__ import annotations

import dataclasses

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
    """Iterator of ``{"tokens": (global_batch, seq_len + 1) int32}``."""

    def __init__(self, cfg: DataConfig, *, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab, size=(64, cfg.motif_len)).astype(np.int32)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def next_batch(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.step, 0))
        toks = rng.choice(cfg.vocab, size=(cfg.global_batch, cfg.seq_len + 1),
                          p=self._p).astype(np.int32)
        n_splice = int(cfg.seq_len * cfg.motif_prob / cfg.motif_len)
        for b in range(cfg.global_batch):
            pos = rng.integers(0, cfg.seq_len - cfg.motif_len, size=n_splice)
            mid = rng.integers(0, len(self._motifs), size=n_splice)
            for p0, m in zip(pos, mid):
                toks[b, p0:p0 + cfg.motif_len] = self._motifs[m]
        self.step += 1
        return {"tokens": toks}
