"""Multi-pod dry run: build every (arch x shape) cell's step on the
production meshes, run it once on meta tensors, and record memory, cost and
collectives for the roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh single --mode hier --out experiments/dryrun_torch

The reference's ``repro/launch/dryrun.py`` for the port.  The reference
lowers and compiles each cell on 512 fake XLA devices and reads XLA's
memory and cost analyses and the HLO; eager PyTorch has neither, so a cell
here is one step run on ``meta`` tensors (shapes and dtypes, no data, no
device) over ``launch.mesh.make_production_mesh(multi_pod=...,
device="meta")`` — ``(data 16, model 16)`` or ``(pod 2, data 16, model
16)``, which costs nothing to build — through ``runtime.steps.
make_train_step`` / ``make_serve_steps``, with four counts taken:

* FLOP: ``torch.utils.flop_counter.FlopCounterMode``; the products'
  FLOP are also split by dtype, which sets each one's route in the
  roofline (``analysis.roofline``);
* bytes accessed: a ``TorchDispatchMode`` that adds up each op's input and
  output bytes (views and allocations move nothing and are skipped);
* kernel calls, which neither mode can see inside: each wrapper of
  ``kernels.ops`` has a meta branch that returns empty outputs of the
  kernel's shapes and notes its analytic FLOP and bytes
  (``ops.counting``), the counts ``chip_smoke.py``'s bounds use;
* collectives: the substrate's traffic record
  (``substrate.collectives.recording``), priced per rank with the ring
  model (``roofline.CollectiveBytes.from_records``).

The step runs the model once per memory domain (a node in hier, a tp group
in naive: up to 32 runs at ``multi``).  The domains of one step run the
same program on the same shapes, so the dry run traces the first and
counts the rest by multiplication (``models.domains.first_domain_only``);
the traffic record already keeps the first domain's collectives as each
rank's (``muted``).  The sLSTM's time loop (4096 alike steps at
``train_4k``) is one step traced the same way, forward and backward
(``models.domains.scan``).  FLOP and bytes per device are the step's
totals over the ranks.

``memory`` is per rank, as the reference's memory analysis is per device:
``argument_bytes`` the state (train: params, m, v, step) or the params
(and, for decode, the cache) plus the batch; ``output_bytes`` the updated
state and the metrics (train), or the cache and the logits.  A hier
node's shared window (a leaf stored along the node's ranks) counts its
shard on each rank — the node holds one copy, split over its ranks as the
GPUs of a node would hold it — and the decode cache, one per memory
domain, its domain's cache over the domain's members.  ``alias_bytes`` is
the donated train state (updated in place), counted once in ``rank_bytes``
= argument + output - alias, the bytes each rank holds against the card's
80 GB.  ``temp_bytes`` is null: meta tensors cannot measure a step's
transients.

A cell record is the reference's: ``status`` (``ok`` / ``skip`` through
``configs.shapes.cell_applicable`` / ``fail`` with the error), ``memory``,
``cost``, ``collectives`` (``fast_bytes_per_dev``, ``slow_bytes_per_dev``,
``by_op``), ``roofline`` (``RooflineTerms.to_dict``) and ``n_units``,
cached in ``{arch}__{shape}__{single|multi}__{mode}.json`` under
``--out``; the CLI exits 1 on any ``fail``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.analysis.roofline import (HBM_BYTES, CollectiveBytes,
                                           roofline)
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, cell_applicable,
                                        get_shape)
from repro_torch.core.topology import MeshTopology, multi_pod, single_pod
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh_from_topo
from repro_torch.models.domains import first_domain_only
from repro_torch.runtime.steps import (make_cluster_train_step,
                                       make_serve_steps, make_train_step)
from repro_torch.substrate import VirtualCluster
from repro_torch.substrate.collectives import recording

META = torch.device("meta")

_ALLOC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                    "new_empty_strided", "lift_fresh"))


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _BytesMode(TorchDispatchMode):
    """Each op's input and output bytes (views and allocations skipped),
    and the FLOP of the ops ``FlopCounterMode`` counts, by the dtype of
    their first operand."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.flops_by_dtype: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if getattr(func, "is_view", False) or packet.__name__ in _ALLOC:
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            if flops:
                dtype = _tensors(args)[0].dtype
                self.flops_by_dtype[dtype] = \
                    self.flops_by_dtype.get(dtype, 0) + flops
        return out


class _Counts:
    """The four counts of one traced step, each repeated run scaled: the
    probe of ``models.domains.first_domain_only`` is entered around the
    first memory domain's run (``kind`` "domains") and around one step of
    a time loop of alike steps (``"steps"``, inside a domain run: the
    scales multiply)."""

    def __init__(self):
        self.flop_mode = FlopCounterMode(display=False)
        self.bytes_mode = _BytesMode()
        self.kernels: list = []
        self.weights: dict = {}          # index in kernels -> scale
        self.extra_flops = 0.0
        self.extra_bytes = 0.0
        self.extra_by_dtype: dict = {}
        self.repeats: dict = {}          # kind -> the largest count seen

    def _snap(self):
        by_dtype = dict(self.bytes_mode.flops_by_dtype)
        for dt, f in self.extra_by_dtype.items():
            by_dtype[dt] = by_dtype.get(dt, 0.0) + f
        return (self.flop_mode.get_total_flops() + self.extra_flops,
                self.bytes_mode.bytes + self.extra_bytes, by_dtype,
                len(self.kernels))

    @contextlib.contextmanager
    def __call__(self, count: int, kind: str = "domains"):
        f0, b0, d0, k0 = self._snap()
        yield
        f1, b1, d1, k1 = self._snap()
        more = count - 1
        self.repeats[kind] = max(self.repeats.get(kind, 1), count)
        self.extra_flops += more * (f1 - f0)
        self.extra_bytes += more * (b1 - b0)
        for dt, f in d1.items():
            self.extra_by_dtype[dt] = self.extra_by_dtype.get(dt, 0.0) \
                + more * (f - d0.get(dt, 0.0))
        for i in range(k0, k1):
            self.weights[i] = self.weights.get(i, 1) * count

    @contextlib.contextmanager
    def tracing(self):
        with recording() as rec, ops.counting() as kern, \
                first_domain_only(self), self.flop_mode, self.bytes_mode:
            self.kernels = kern
            yield rec

    def totals(self) -> dict:
        """The step's totals over all ranks: FLOP (with the kernels'), the
        products' FLOP by route, bytes, and the kernels by name."""
        by_route: dict = {}
        for dt, f in self._snap()[2].items():
            route = "bf16" if dt in (torch.bfloat16, torch.float16) \
                else "fma"
            by_route[route] = by_route.get(route, 0.0) + f
        kernels: dict = {}
        for i, c in enumerate(self.kernels):
            w = self.weights.get(i, 1)
            k = kernels.setdefault(c.name, {"calls": 0, "flops": 0.0,
                                            "bytes": 0.0, "route": c.route})
            k["calls"] += w
            k["flops"] += w * c.flops
            k["bytes"] += w * c.bytes
            by_route[c.route] = by_route.get(c.route, 0.0) + w * c.flops
        flops, nbytes = self._snap()[:2]
        flops += sum(k["flops"] for k in kernels.values())
        nbytes += sum(k["bytes"] for k in kernels.values())
        return {"flops": float(flops), "bytes": float(nbytes),
                "flops_by_route": by_route, "kernels": kernels,
                "domains": self.repeats.get("domains", 1),
                "loop_steps": self.repeats.get("steps", 1)}


def _rank_bytes(stacked, R: int) -> int:
    """Bytes a rank holds of a stacked tree ``(R, *local)``."""
    return sum(_nbytes(t) for t in _tensors(stacked)) // R


def _abstract_batch(cfg: ModelConfig, B: int, T_: int) -> dict:
    """The global batch's leaves on meta (the reference's
    ``abstract_batch``)."""
    if cfg.frontend == "encodec":
        return {"frames": torch.empty((B, T_, cfg.d_frontend), device=META),
                "labels": torch.empty((B, T_), dtype=torch.int32,
                                      device=META)}
    out = {"tokens": torch.empty((B, T_ + 1), dtype=torch.int32,
                                 device=META)}
    if cfg.frontend == "vit":
        out["patches"] = torch.empty((B, cfg.n_prefix, cfg.d_frontend),
                                     device=META)
    return out


def _trace_train(bundle, B: int, T_: int) -> dict:
    vc = bundle.vc
    R = vc.num_devices
    state = bundle.layout_state(bundle.abstract_state())
    batch = bundle.layout_batch(_abstract_batch(bundle.model.cfg, B, T_))
    state_b = _rank_bytes(state, R)
    batch_b = _rank_bytes(batch, R)
    counts = _Counts()
    with counts.tracing() as rec:
        state, metrics = bundle.step(state, batch)
    out_b = state_b + _rank_bytes(metrics, R)
    return {"counts": counts.totals(), "records": list(rec),
            "memory": {"argument_bytes": state_b + batch_b,
                       "output_bytes": out_b, "alias_bytes": state_b}}


def _trace_serve(sb, cfg: ModelConfig, shape: ShapeSpec) -> dict:
    R = sb.vc.num_devices
    B = shape.global_batch
    counts = _Counts()
    if shape.kind == "prefill":
        params = sb.layout_params(sb.model.abstract_params(
            sb.prefill_param_specs), serve=False)
        batch = sb.layout_batch(_abstract_batch(cfg, B, shape.seq_len))
        arg_b = _rank_bytes(params, R) + _rank_bytes(batch, R)
        with counts.tracing() as rec:
            cache, logits = sb.prefill(params, batch)
    else:
        params = sb.layout_params(sb.model.abstract_params(
            sb.param_specs, serve=True), serve=True)
        cache = sb.cache_init()
        tok = torch.empty((B, 1, cfg.d_frontend), device=META) \
            if cfg.frontend == "encodec" else \
            torch.empty((B, 1), dtype=torch.int32, device=META)
        tok = sb.layout_tokens(tok)
        arg_b = _rank_bytes(params, R) + _rank_bytes(dict(cache), R) \
            + _rank_bytes(tok, R)
        with counts.tracing() as rec:
            cache, logits = sb.decode(params, cache, tok, shape.seq_len - 1)
    out_b = _rank_bytes(dict(cache), R) + _rank_bytes(logits, R)
    return {"counts": counts.totals(), "records": list(rec),
            "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                       "alias_bytes": 0}}


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """The useful FLOP of a step (the reference's): 6 N tokens to train, 2
    N tokens to prefill, 2 N per sequence for a decode step, N the active
    parameters."""
    n = cfg.active_param_count()
    B, T_ = shape.global_batch, shape.seq_len
    return {"train": 6.0 * n * B * T_, "prefill": 2.0 * n * B * T_,
            "decode": 2.0 * n * B}[shape.kind]


def trace_cell(cfg: Union[str, ModelConfig], shape: Union[str, ShapeSpec],
               topo: Union[MeshTopology, VirtualCluster], *,
               mode: str = "hier", opts=(),
               compute_dtype: Optional[torch.dtype] = None) -> dict:
    """One cell's step on meta tensors.  ``topo``: a ``MeshTopology``
    (``make_train_step`` / ``make_serve_steps`` on its stacked mesh, the
    production entry points) or a ``VirtualCluster`` (a train shape
    through ``make_cluster_train_step`` on it).  ``compute_dtype``: the
    entry point's default (bf16 on the production mesh) unless given.
    Returns the record's ``memory``, ``cost``, ``collectives``,
    ``roofline`` and ``n_units``."""
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    shape = get_shape(shape) if isinstance(shape, str) else shape
    if cfg.moe and any(str(o).startswith("cap=") for o in opts):
        cf = float([o for o in opts if str(o).startswith("cap=")][0][4:])
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    opts = tuple(o for o in opts if not str(o).startswith("cap="))
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    if isinstance(topo, VirtualCluster):
        if shape.kind != "train":
            raise ValueError("a VirtualCluster cell traces a train step")
        vc = dataclasses.replace(topo, device=META)
        bundle = make_cluster_train_step(cfg, vc, mode=mode, opts=opts,
                                         global_batch=shape.global_batch,
                                         **kw)
        out = _trace_train(bundle, shape.global_batch, shape.seq_len)
    else:
        vc = make_mesh_from_topo(topo, device=META)
        if shape.kind == "train":
            bundle = make_train_step(cfg, topo, vc, mode=mode, opts=opts,
                                     **kw)
            out = _trace_train(bundle, shape.global_batch, shape.seq_len)
        else:
            sb = make_serve_steps(cfg, topo, vc, mode=mode,
                                  global_batch=shape.global_batch,
                                  s_max=shape.seq_len, opts=opts, **kw)
            out = _trace_serve(sb, cfg, shape)
    R = vc.num_devices
    counts = out["counts"]
    coll = CollectiveBytes.from_records(out["records"])
    terms = roofline(
        flops_per_dev={r: f / R for r, f in counts["flops_by_route"].items()},
        bytes_per_dev=counts["bytes"] / R, coll=coll, chips=R,
        model_flops=model_flops(cfg, shape))
    memory = dict(out["memory"], temp_bytes=None)
    memory["rank_bytes"] = memory["argument_bytes"] \
        + memory["output_bytes"] - memory["alias_bytes"]
    memory["fits_80gb"] = memory["rank_bytes"] <= HBM_BYTES
    return {"memory": memory,
            "cost": {"flops": counts["flops"], "bytes": counts["bytes"],
                     "flops_per_dev": counts["flops"] / R,
                     "bytes_per_dev": counts["bytes"] / R,
                     "flops_by_route": counts["flops_by_route"],
                     "kernels": counts["kernels"],
                     "domains": counts["domains"],
                     "loop_steps": counts["loop_steps"], "ranks": R},
            "collectives": {"fast_bytes_per_dev": coll.fast,
                            "slow_bytes_per_dev": coll.slow,
                            "by_op": coll.by_op},
            "roofline": terms.to_dict(), "n_units": cfg.n_units}


def run_cell(arch: str, shape_name: str, multi: bool, mode: str,
             opts=()) -> dict:
    rec = {"arch": arch, "shape": shape_name, "opts": list(opts),
           "mesh": "multi" if multi else "single", "mode": mode}
    if not cell_applicable(arch, shape_name):
        rec["status"] = "skip"
        rec["reason"] = ("full-attention arch: 500k dense-KV decode is "
                         "architecturally out of scope (DESIGN.md §5)")
        return rec
    try:
        t0 = time.time()
        rec.update(trace_cell(arch, shape_name,
                              multi_pod() if multi else single_pod(),
                              mode=mode, opts=opts))
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    return rec


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--mode", default="hier", choices=["hier", "naive",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--opts", default="",
                    help="comma list: decode2d,serve_fsdp,cap=1.25,...")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opts.split(",") if o)

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    modes = ["hier", "naive"] if args.mode == "both" else [args.mode]

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                for mode in modes:
                    tag = (f"{arch}__{shape}__"
                           f"{'multi' if multi else 'single'}__{mode}")
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path):
                        with open(path) as f:
                            rec = json.load(f)
                        if rec.get("status") in ("ok", "skip"):
                            print(f"CACHED {tag}: {rec['status']}")
                            continue
                    rec = run_cell(arch, shape, multi, mode, opts=opts)
                    with open(path, "w") as f:
                        json.dump(_jsonable(rec), f, indent=1)
                    msg = rec["status"]
                    if rec["status"] == "ok":
                        r, m = rec["roofline"], rec["memory"]
                        msg += (f" trace={rec['trace_s']}s"
                                f" dom={r['dominant']}"
                                f" comp={r['compute_s']*1e3:.1f}ms"
                                f" mem={r['memory_s']*1e3:.1f}ms"
                                f" coll={r['collective_s']*1e3:.1f}ms"
                                f" frac={r['roofline_fraction']:.2f}"
                                f" rank={m['rank_bytes'] / 1e9:.2f}GB"
                                f" of {HBM_BYTES / 1e9:.0f}GB"
                                + ("" if m["fits_80gb"] else " OVER"))
                    elif rec["status"] == "fail":
                        n_fail += 1
                        msg += " " + rec["error"][:200]
                    print(f"{tag}: {msg}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
