"""``serving`` bench family: continuous-batching decode steps under load.

The reference's ``repro/bench/serving.py`` on the port's substrate.  The
``step_time`` family times whole train steps; this family times the
serving engine's inner loop — ONE decode step over a full slot batch with
a heterogeneous per-slot position vector, the weights in the node's
one-copy window store (the ``serve_fsdp`` layout, run once per memory
domain: ``models.transformer.ClusterModel``).  Two schemes:

* ``sync``     — issue-at-use: ``model.decode_fn``, every unit's window
  read issued inside the unit's run when the weight is used;
* ``recorded`` — ``serving.recorded.RecordedDecoder``: the step's window
  reads recorded into one ``CollectiveGraph``, deduped, front-loaded on
  the side stream as one node buffer per node, replayed per batch
  signature; outputs bit-identical to ``sync``.

As for ``step_time``, a decode step's collective content is whatever the
model runs, so each scheme carries a per-config **link inventory** recorded
from one untimed step (``bench.step_time.link_inventory``: the substrate's
traffic record, a window read as the all-gather it stands for), and
``bench.validate`` holds every timed rep's own record to it.  The cases
are timed eagerly with CUDA events (``BenchCase.eager``).  The reduced
decode steps are host-bound: their times rank nothing, and the family is a
traffic check on the card.

The measured step median then prices an **open-loop Poisson load model**
(``serving_metrics``): requests arrive at a fixed offered utilization,
occupy one of ``slots`` decode lanes for ``max_new`` steps, and every
emitted token's latency is a sample — ``tokens_per_s`` and the p50 / p99
per-token latency land in the case's report record.  The model is a pure,
seeded function of the median (numpy only), the reference's arithmetic.

Case sizing: ``elems`` is the model's global parameter element count, so
quick and full sweeps land on the same cells.
"""

from __future__ import annotations

import math
from types import MappingProxyType

import numpy as np
import torch

from repro_torch.bench.step_time import (StepTimeScheme, _no_dispatch,
                                         link_inventory)
from repro_torch.bench.suites import BenchCase, _swept
from repro_torch.comm import registry
from repro_torch.comm.registry import register_scheme
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.substrate import collectives as coll
from repro_torch.substrate.cluster import P

#: model-zoo configs the family times (reduced shapes; a dense untied
#: global-attention entry, as in the reference)
SERVE_CONFIGS = ("starcoder2-7b",)
SERVE_SLOTS = 4                 # decode lanes = batch rows per step
SERVE_SMAX = 32                 # KV page length per lane

#: open-loop load-model constants (fixed, so every report row is
#: comparable across topologies and runs)
LOAD_MAX_NEW = 8
LOAD_REQUESTS = 64
LOAD_UTILIZATION = 0.8
LOAD_SEED = 0

#: why the family is timed eagerly (``TimingResult.note``)
EAGER_NOTE = ("a decode step run once per memory domain (Python loops, "
              "the recorded schedule's side stream) is timed eagerly with "
              "CUDA events, not captured")


# ---------------------------------------------------------------------------
# The two serving schemes
# ---------------------------------------------------------------------------

class ServingScheme(StepTimeScheme):
    """Base of the ``serving`` schemes: a per-config recorded link
    inventory (no closed form in (pods, chips, elems) exists for a decode
    step)."""

    FAMILY = "serving"
    ops = MappingProxyType({"serving": _no_dispatch})
    N_OUT = 2                   # logits + cache checksums: replicated f32


class ServeSyncScheme(ServingScheme):
    """Issue-at-use: ``model.decode_fn`` — each unit's window reads issued
    inside the unit's run when the weight is used."""

    name = "sync"


class ServeRecordedScheme(ServingScheme):
    """The recorded decode step (``serving.recorded.RecordedDecoder``):
    window reads recorded into one ``CollectiveGraph``, same-epoch
    duplicates deduped, the issues front-loaded behind one event, replayed
    per batch signature.  Bit-identical to ``sync``."""

    name = "recorded"


SYNC = register_scheme(ServeSyncScheme())
RECORDED = register_scheme(ServeRecordedScheme())


# ---------------------------------------------------------------------------
# Open-loop Poisson load model
# ---------------------------------------------------------------------------

def serving_metrics(step_us: float, *, slots: int = SERVE_SLOTS,
                    max_new: int = LOAD_MAX_NEW,
                    n_requests: int = LOAD_REQUESTS,
                    utilization: float = LOAD_UTILIZATION,
                    seed: int = LOAD_SEED) -> dict:
    """Open-loop Poisson serving simulation priced by one measured median.

    Requests arrive as a Poisson process offered at ``utilization`` of the
    engine's token capacity (``slots`` lanes, each token one ``step_us``
    engine step); a request holds one lane for ``max_new`` steps and
    queues FIFO while every lane is busy.  Every emitted token is one
    latency sample: a request's FIRST token pays its queue wait plus one
    step, later tokens the inter-token step.  Deterministic: seeded
    arrivals, a discrete event loop, no wall clock."""
    if step_us <= 0:
        raise ValueError("step_us must be positive")
    step_s = step_us * 1e-6
    rate = utilization * slots / (max_new * step_s)   # offered requests/s
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    lanes: list[list] = []      # [steps_remaining, last_event_time]
    t = 0.0
    nxt = 0
    latencies: list[float] = []
    tokens = 0
    while nxt < n_requests or lanes:
        if not lanes:           # idle: jump to the next arrival
            t = max(t, arrivals[nxt])
        while (nxt < n_requests and len(lanes) < slots
               and arrivals[nxt] <= t):
            lanes.append([max_new, arrivals[nxt]])
            nxt += 1
        t_end = t + step_s
        for lane in lanes:
            latencies.append(t_end - lane[1])
            lane[1] = t_end
            lane[0] -= 1
            tokens += 1
        lanes = [ln for ln in lanes if ln[0] > 0]
        t = t_end
    lat_ms = np.asarray(latencies) * 1e3
    return {
        "tokens_per_s": float(tokens / t),
        "p50_token_ms": float(np.percentile(lat_ms, 50)),
        "p99_token_ms": float(np.percentile(lat_ms, 99)),
        "step_us": float(step_us),
        "slots": slots, "max_new": max_new, "requests": n_requests,
        "utilization": utilization, "offered_rps": float(rate),
        "sim_seed": seed,
    }


# ---------------------------------------------------------------------------
# Case builder
# ---------------------------------------------------------------------------

def cache_checksums(cache) -> torch.Tensor:
    """Each rank's sum over its own cache (its domain's, its tp rank's
    chunk), stacked ``(R,)`` f32 — what the reference sums per rank."""
    lay = cache.domains
    keep = 2 if lay.tp_dim else 1
    tot = 0.0
    for k, sub in cache.items():
        for a in T.leaves(sub):
            x = a.float().movedim(2, 1) if (lay.tp_dim and k == "units") \
                else a.float()
            tot = tot + x.sum(dim=tuple(range(keep, x.dim())))
    return lay.to_ranks(list(tot))


def serving_cases(vc, on_skip=None, schemes=None):
    """One case per (model config, serving scheme) on this cluster.

    Builds the slot-batch decode-step body in the ``serve_fsdp`` layout,
    records its link inventory on the scheme from one untimed step, and
    yields a ``BenchCase`` whose timed runs the validate layer holds to
    it."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.models.transformer import build
    from repro_torch.runtime.steps import cluster_ctx
    from repro_torch.serving.recorded import RecordedDecoder

    for cfg_name in SERVE_CONFIGS:
        cfg = get_config(cfg_name).reduced()
        ctx = cluster_ctx(vc, opts=("serve_fsdp",))
        sizes = dict(zip(vc.axis_names, vc.axis_shapes))
        data = math.prod(sizes[a] for a in ctx.fsdp_axes)
        model = build(cfg, ctx, data=data, device=vc.device)
        pspecs = model.param_specs(
            serve=True, tp_axis=ctx.tp_axis,
            fsdp_axis=ctx.fsdp_axes[0] if ctx.fsdp_axes else None)
        in_specs = tuple(T.leaves(pspecs)) + (P(), P())
        elems = sum(math.prod(t.shape) for t in T.leaves(
            model.abstract_params(pspecs, serve=True)))
        axes = vc.axis_names

        def make_args(model=model, cfg=cfg, in_specs=in_specs):
            params = model.init_params(0)
            stream = SyntheticLM(DataConfig(
                vocab=cfg.vocab, seq_len=SERVE_SMAX,
                global_batch=SERVE_SLOTS, seed=7))
            toks = stream.next_batch()["tokens"]
            tok = torch.from_numpy(toks[:, :1].astype(np.int32))
            # heterogeneous per-slot positions: the continuous-batching
            # signature (every lane mid-stream at a different depth)
            pos = torch.from_numpy(((np.arange(SERVE_SLOTS) * 5 + 1)
                                    % SERVE_SMAX).astype(np.int32))
            return tuple(vc.layout(x, spec) for x, spec in zip(
                T.leaves(params) + [tok, pos], in_specs))

        for sch in _swept(registry.schemes_for("serving"), schemes):
            decode = RecordedDecoder(model) if sch.name == "recorded" \
                else model.decode_fn

            def body(*args, _decode=decode, _specs=pspecs, _model=model,
                     _axes=axes):
                pl, tok, pos = args[:-2], args[-2], args[-1]
                p = T.unflatten(_specs, list(pl))
                cache = _model.cache_init(SERVE_SLOTS, SERVE_SMAX)
                new_cache, logits = _decode(p, cache, tok, pos)
                # two replicated f32 checksums keep the logits AND the
                # cache update in the step: each a psum over the whole mesh
                chk_l = coll.psum(logits.float().sum(
                    dim=tuple(range(1, logits.dim()))), _axes)
                chk_c = coll.psum(cache_checksums(new_cache), _axes)
                return chk_l, chk_c

            fast_b, slow_b = link_inventory(body, make_args(), vc)
            sch.record(pods=vc.pods, chips=vc.chips,
                       fast_shape=vc.fast_shape, elems=elems,
                       fast=fast_b, slow=slow_b)
            yield BenchCase(
                "serving", sch.name, vc, elems, make_args=make_args,
                traffic=sch.traffic_for(pods=vc.pods, chips=vc.chips,
                                        fast_shape=vc.fast_shape,
                                        elems=elems),
                body_with=lambda _opts, b=body: b, eager=EAGER_NOTE)
