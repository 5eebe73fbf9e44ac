"""Serve a tiny LM with the continuous-batching engine.

The counterpart of the reference's ``examples/serve_lm.py``: the reduced
``qwen3-0.6b`` (weights drawn on the device from seed 0), five prompts of
5, 11, 3, 8 and 6 tokens through the request queue into 2 decode slots
(finished slots are refilled mid-flight), 6 new tokens each, and the two
serving guarantees:

* every request's token stream is IDENTICAL to running it alone —
  batching never changes outputs (it raises otherwise);
* the scheduler's measured decode latencies feed a ``LiveTuner``
  overlay local to the process, so ``scheme="auto"`` can track the live
  traffic without touching the committed tuning table (its EWMA line).

    PYTHONPATH=src python -m repro_torch.apps.serve_lm [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.comm.tuning import topo_signature
from repro_torch.models import build_by_name
from repro_torch.serving.live_tuning import LiveTuner
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           generate)


def run(device="cuda"):
    """Serve the five prompts; returns ``{rid: (tokens, solo tokens)}``
    and the live tuner's estimate (us)."""
    model = build_by_name("qwen3-0.6b", reduced=True, device=device)
    params = model.init_params(0)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, size=n).astype(np.int32)
               for n in (5, 11, 3, 8, 6)]

    tuner = LiveTuner(min_count=1)
    sched = ContinuousBatchingScheduler(model, params, slots=2, s_max=24,
                                        tuner=tuner)
    rids = [sched.queue.submit(p, 6) for p in prompts]
    results = sched.run()

    print(f"{len(prompts)} requests through 2 slots, "
          f"{len(sched.stats)} decode steps "
          f"(mean batch {np.mean([s.active for s in sched.stats]):.2f}):")
    out = {}
    for rid, p in zip(rids, prompts):
        solo = generate(model, params, [p], max_new=6, slots=1, s_max=24)
        same = np.array_equal(results[rid].tokens, solo.tokens)
        print(f"  req{rid} (prompt {p.size:2d} tok) -> "
              f"{results[rid].tokens[0].tolist()}  "
              f"{'== solo run' if same else 'MISMATCH'}")
        if not same:
            raise AssertionError("continuous batching must not change "
                                 "outputs")
        out[rid] = (results[rid].tokens, solo.tokens)

    k = sched._tuner_key
    est = tuner.estimate("serving", topo_signature(k["pods"], k["chips"]),
                         "float32", k["nbytes"], k["scheme"])
    print(f"live tuner: serving/{k['scheme']} decode EWMA {est:.0f} us; "
          f"overlay carries {len(tuner.overlay().entries)} entries "
          f"(committed table untouched)")
    return out, est


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="continuous batching of a "
                                             "tiny LM")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is visible "
                         "(pass --device cpu)")
    run(torch.device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
