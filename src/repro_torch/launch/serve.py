"""Serving launcher: continuous batching under open-loop Poisson load.

Drives :class:`repro_torch.serving.scheduler.ContinuousBatchingScheduler` the
way a real frontend would: requests with heterogeneous prompt lengths arrive
on a Poisson process (open loop — arrivals do not wait for completions), are
admitted through the bounded queue, and decode together in fixed slots.
Reports throughput (tokens/sec), decode-step latency percentiles, and
end-to-end request latency percentiles.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 32 --slots 4 --max-new 8 --rate 50 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --device cpu

The model is the arch's ``reduced()`` config, as in the reference's
launcher; weights are random, drawn on the device from ``--seed``.
``--rate 0`` (the default)
submits everything up front — a closed batch.  ``--live-tuning`` feeds each
decode step's latency to a ``LiveTuner`` and prints its EWMA and the size
of the overlay table it would install.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.models import build_by_name
from repro_torch.serving.queue import AdmissionError
from repro_torch.serving.scheduler import ContinuousBatchingScheduler


def _pct(xs, q):
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(np.ceil(q * len(s))) - 1))]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="continuous-batching serving driver (synthetic load)")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-max", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=None)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="mean request arrival rate (req/s); 0 = submit "
                         "everything up front")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--live-tuning", action="store_true",
                    help="feed decode-step latencies to a LiveTuner")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("serve: no CUDA device (pass --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False

    model = build_by_name(args.arch, reduced=True, device=dev)
    params = model.init_params(args.seed)
    s_max = args.s_max or (args.prompt_max + args.max_new)

    # heterogeneous prompts drawn from the synthetic pipeline
    lm = SyntheticLM(DataConfig(vocab=model.cfg.vocab,
                                seq_len=args.prompt_max,
                                global_batch=args.requests, seed=args.seed))
    tokens = np.asarray(lm.next_batch()["tokens"])
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(2, args.prompt_max + 1, size=args.requests)
    prompts = [tokens[i, :lengths[i]].astype(np.int32)
               for i in range(args.requests)]
    arrivals = (np.zeros(args.requests) if args.rate <= 0 else
                rng.exponential(1.0 / args.rate, args.requests).cumsum())

    tuner = None
    if args.live_tuning:
        from repro_torch.serving.live_tuning import LiveTuner
        tuner = LiveTuner(min_count=1)

    sched = ContinuousBatchingScheduler(
        model, params, slots=args.slots, s_max=s_max,
        temperature=args.temperature, seed=args.seed, tuner=tuner)

    done_at: dict[int, float] = {}
    rid_arrival: dict[int, float] = {}
    nxt = 0
    t0 = time.perf_counter()
    while len(sched.results) < args.requests:
        now = time.perf_counter() - t0
        while nxt < args.requests and arrivals[nxt] <= now:
            try:
                rid = sched.queue.submit(prompts[nxt], args.max_new,
                                         arrival=arrivals[nxt])
            except AdmissionError:
                break                       # backpressure: retry next loop
            rid_arrival[rid] = arrivals[nxt]
            nxt += 1
        busy = sched.step()
        now = time.perf_counter() - t0
        for rid in sched.results:
            done_at.setdefault(rid, now)
        if not busy and nxt < args.requests:
            time.sleep(max(0.0, arrivals[nxt] - now))
    elapsed = time.perf_counter() - t0

    total_tokens = sum(r.tokens.size for r in sched.results.values())
    step_us = [s.decode_us for s in sched.stats if s.active]
    e2e_ms = [1e3 * (done_at[r] - rid_arrival[r]) for r in sched.results]
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{args.arch} (reduced) on {where}: "
          f"{args.requests} requests, {args.slots} slots, "
          f"rate={'inf' if args.rate <= 0 else args.rate}/s")
    print(f"  tokens/sec:      {total_tokens / elapsed:10.1f}")
    print(f"  decode step us:  p50 {_pct(step_us, 0.5):8.0f}   "
          f"p99 {_pct(step_us, 0.99):8.0f}")
    print(f"  request e2e ms:  p50 {_pct(e2e_ms, 0.5):8.1f}   "
          f"p99 {_pct(e2e_ms, 0.99):8.1f}")
    print(f"  steps: {len(sched.stats)}  mean batch: "
          f"{np.mean([s.active for s in sched.stats if s.active]):.2f}")
    if tuner is not None:
        k = sched._tuner_key
        from repro_torch.comm.tuning import topo_signature
        est = tuner.estimate("serving", topo_signature(k["pods"], k["chips"]),
                             "float32", k["nbytes"], k["scheme"])
        print(f"  live tuner: serving/{k['scheme']} EWMA {est:.0f} us "
              f"({len(sched.stats)} observations) — overlay has "
              f"{len(tuner.overlay().entries)} entries")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
