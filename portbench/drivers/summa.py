"""SUMMA on the stacked grid: ``repro_torch.apps.summa.summa``.

Set-up draws ``operand_pairs`` pairs of (n, n) f32 operands on the card
from the seed and warms the window's step up on each pair (the first
builds the panel kernel).  The window's unit is one multiply, the pairs in
turn.  Each multiply's C is kept until the next one is called, and a
sample of its rows, drawn from the seed ahead of the window, is copied
aside on the card.  The check compares every sampled row of every
multiply, and the whole C of the window's last multiply, with the plain
f32 product (``reference.summa``).
"""

from __future__ import annotations

import torch

from portbench.check import Check
from portbench.reference import summa as ref

#: Row samples drawn ahead of the window: one set a multiply, reused past
#: this many multiplies.
SAMPLE_SETS = 4096


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.apps import summa as app
        grid = cfg["grid"]
        if (app.NODES, app.CORES) != (grid["nodes"], grid["cores"]):
            raise ValueError(f"apps.summa runs a {app.NODES}x{app.CORES} "
                             f"grid; {cfg['name']} states "
                             f"{grid['nodes']}x{grid['cores']}")
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
        self.app = app
        self.cfg, self.traffic = cfg, traffic
        self.kw = dict(scheme=traffic["scheme"], use_kernel=cfg["use_kernel"],
                       chunks=traffic["chunks"])
        n = traffic["n"]
        g = torch.Generator(device=device).manual_seed(seed)
        self.pairs = [(torch.randn((n, n), generator=g, device=device),
                       torch.randn((n, n), generator=g, device=device))
                      for _ in range(traffic["operand_pairs"])]
        k = traffic["rows_checked_per_multiply"]
        self.rows = torch.randint(n, (SAMPLE_SETS, k), generator=g,
                                  device=device)
        self.stats: dict = {}
        self._reset()
        for _ in self.pairs:        # warm-up: the window's own step, once
            self.step()             # on every operand pair
        self._reset()

    def _reset(self) -> None:
        self.samples: list[torch.Tensor] = []
        self.last = None
        self.calls = 0

    def step(self) -> None:
        i = self.calls
        a, b = self.pairs[i % len(self.pairs)]
        self.last = None
        self.last = self.app.summa(a, b, **self.kw)
        self.samples.append(torch.index_select(
            self.last, 0, self.rows[i % SAMPLE_SETS]))
        self.calls += 1

    def counters(self) -> dict:
        return {"multiplies": self.calls}

    def end_to_end(self, window) -> dict:
        return {"summa_ms": 1e3 * window.seconds / window.units}

    def release(self) -> None:
        """The program holds no state between multiplies."""

    def check(self) -> list[Check]:
        self.errs = []
        P = len(self.pairs)
        for p, (a, b) in enumerate(self.pairs):
            idx = list(range(p, self.calls, P))
            if not idx:
                continue
            rows = torch.cat([self.rows[i % SAMPLE_SETS] for i in idx])
            want = ref.product(a[rows], b).split(self.rows.shape[1])
            self.errs += [ref.rel_err(self.samples[i], w)
                          for i, w in zip(idx, want)]
            del want
        a, b = self.pairs[(self.calls - 1) % P]
        full = ref.rel_err(self.last, ref.product(a, b))
        return checks(self.cfg, self.errs + [full])

    def failed_units(self, checks: list[Check]) -> int:
        lim = self.cfg["limits"]["rel_err"]
        return max(1, sum(not e <= lim for e in self.errs))


def checks(cfg: dict, errs: list[float]) -> list[Check]:
    """The worst of ``errs`` against the configuration's limit."""
    return [Check("rel_err", max(errs), cfg["limits"]["rel_err"])]


def control_readings(cell, seed: int, device) -> dict[str, list[Check]]:
    """The control judged as a run is: the whole product of the window's
    first operand pair (drawn as set-up draws it) on TF32 operands."""
    n = cell.traffic["n"]
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((n, n), generator=g, device=device)
    b = torch.randn((n, n), generator=g, device=device)
    want = ref.product(a, b)
    got = ref.product(a, b, precision="tf32")
    return {"control": checks(cell.config, [ref.rel_err(got, want)])}


def setup(cfg: dict, traffic: dict, seed: int, device) -> Session:
    return Session(cfg, traffic, seed, device)
