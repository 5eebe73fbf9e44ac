"""Training launcher: the cluster train step over a synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        [--reduced] --topology 2x4|2x(2x2) --mode hier|naive --steps N \\
        --batch B --seq T [--device cuda|cpu] [--opts prefetch,stepgraph] \\
        [--ckpt DIR --save-every N]

Builds ``runtime.steps.make_cluster_train_step`` on a stacked
``VirtualCluster`` (``--topology``: ``PODSxCHIPS``, or ``PODSx(DPxTP)``
for a node's fast tier factored over data and tensor parallelism, the
production layout) on one device, draws the parameters from ``--seed`` on
that device, lays the state out (hier: one copy per node, sharded over its
store ranks; naive: a replica per store rank; each tp rank its shard) and
drives ``--steps`` steps over ``data/synthetic.py``'s stream.  It prints
one line per step — the loss (in full), gnorm, the step's milliseconds
(host clock around work that ends in a synchronize) and tokens/s — then the
training state's device bytes by group (params / m / v / grads) and, on
the card, the flash-attention kernel's forward and backward launch
counts.
A ``vit`` / ``encodec`` config (``internvl2-1b``, ``musicgen-medium``)
trains through ``runtime.steps.make_train_step`` on the production mesh of
the same shape (``topology_of``: ``PODSxCHIPS`` is ``{pod, data: CHIPS,
model: 1}``, ``PODSx(DPxTP)`` ``{pod, data: DP, model: TP}``), as the
reference's launcher builds every run, over ``data.synthetic.FrontendLM``'s
stream (the token stream plus the frontend's inputs); a token config keeps
the cluster step.
``--reduced`` is the arch's ``reduced()`` config (``--n-layers``,
``--d-model``); ``--layers N`` cuts the arch to N layers at its full
width.  The steps run through ``runtime.train_loop.train``: with
``--ckpt DIR`` it saves the logical state every ``--save-every`` steps and
at the end, and a rerun resumes from the newest intact step with the data
stream fast-forwarded, so an interrupted and resumed run gives the same
losses as an uninterrupted one.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.core.topology import MeshTopology
from repro_torch.data.synthetic import DataConfig, FrontendLM
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import flash_attention_bwd as kflash_bwd
from repro_torch.launch.mesh import make_mesh_from_topo
from repro_torch.runtime.steps import (make_cluster_train_step,
                                       make_train_step)
from repro_torch.runtime.train_loop import train
from repro_torch.substrate import VirtualCluster


def topology_of(label: str) -> MeshTopology:
    """The production-mesh topology of a cluster label: ``PODSxCHIPS`` ->
    ``{pod: PODS, data: CHIPS, model: 1}``, ``PODSx(DPxTP)`` -> ``{pod:
    PODS, data: DP, model: TP}`` (no pod axis for one node)."""
    vc = VirtualCluster.from_label(label, device="meta")
    shape = vc.fast_shape if len(vc.fast_shape) == 2 \
        else vc.fast_shape + (1,)
    if len(shape) != 2:
        raise ValueError(f"label {label!r}: the production mesh factors a "
                         f"node as (data, model)")
    sizes = {"pod": vc.pods} if vc.pods > 1 else {}
    sizes.update(data=shape[0], model=shape[1])
    return MeshTopology(sizes)


def state_bytes(state: dict, grad_bytes: int) -> dict:
    """Device bytes of the laid-out training state by group."""
    out = {g: sum(t.numel() * t.element_size() for t in T.leaves(state[g]))
           for g in ("params", "m", "v")}
    out["grads"] = grad_bytes
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="cluster train step driver "
                                             "(synthetic tokens)")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to this many layers at its full "
                         "width (without --reduced)")
    ap.add_argument("--topology", default="2x4",
                    help="PODSxCHIPS or PODSx(DPxTP), stacked on the one "
                         "device")
    ap.add_argument("--mode", default="hier", choices=["hier", "naive"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--opts", default="",
                    help="comma-separated ctx opts (prefetch, stepgraph, "
                         "overlap)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: resume from its newest "
                         "intact step, save every --save-every steps")
    ap.add_argument("--save-every", type=int, default=50)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.n_layers, d_model=args.d_model)
    elif args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is visible "
                         "(pass --device cpu)")
    opts = tuple(o for o in args.opts.split(",") if o)
    stream = None
    if cfg.frontend:
        topo = topology_of(args.topology)
        vc = make_mesh_from_topo(topo, device=dev)
        bundle = make_train_step(cfg, topo, vc, mode=args.mode, lr=args.lr,
                                 clip=args.clip, opts=opts,
                                 compute_dtype=torch.float32)

        def stream(dc, start_step):
            return FrontendLM(cfg, dc, start_step=start_step)
    else:
        vc = VirtualCluster.from_label(args.topology, device=dev)
        bundle = make_cluster_train_step(cfg, vc, mode=args.mode, lr=args.lr,
                                         clip=args.clip,
                                         global_batch=args.batch, opts=opts)
    print(f"[train] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}) "
          f"{args.mode} on {vc.label} ({args.device}), global batch "
          f"{args.batch} x {args.seq} tokens, lr {args.lr}, opts "
          f"{list(opts)}"
          + (f", checkpoints in {args.ckpt} every {args.save_every} steps"
             if args.ckpt else ""))
    kflash.launches = kflash_bwd.launches = 0
    tokens = args.batch * args.seq

    def log_step(i, metrics):
        ms = metrics["seconds"] * 1e3
        # the loss in full (repr), so two runs' lines compare exactly
        print(f"[train] step {i + 1} loss {float(metrics['loss'][0])!r} "
              f"gnorm {float(metrics['gnorm'][0]):.6f} step {ms:.1f} ms "
              f"{tokens / ms * 1e3:.1f} tokens/s")

    rep = train(bundle, steps=args.steps,
                data_cfg=DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch,
                                    seed=args.seed),
                ckpt_dir=args.ckpt, save_every=args.save_every, log_every=0,
                seed=args.seed, on_step=log_step, stream=stream)
    if rep.resumed_from:
        print(f"[train] resumed from step {rep.resumed_from}")
    state = rep.state
    sizes = state_bytes(state, bundle.stats.get("grad_bytes", 0))
    tp = bundle.model.ctx.tp
    copies = (f"{vc.pods} node copies" if args.mode == "hier"
              else f"{vc.num_devices // tp} replicas")
    if tp > 1:
        copies += f" of each of {tp} tp shards"
    print("[train] state bytes: "
          + " ".join(f"{k} {v}" for k, v in sizes.items())
          + f" total {sum(sizes.values())} ({copies})")
    if dev.type == "cuda":
        print(f"[train] flash_attention launches: forward "
              f"{kflash.launches} backward {kflash_bwd.launches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
