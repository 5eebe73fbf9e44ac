"""Where the time goes on the card: SUMMA, ``ag_matmul`` and serving under
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.analysis.profile [--n 16384]
        [--chunks 2]
    PYTHONPATH=src python -m repro_torch.analysis.profile --ag-matmul
    PYTHONPATH=src python -m repro_torch.analysis.profile --serve
        [--model recurrentgemma-9b|granite-moe-3b-a800m|xlstm-1.3b]
    PYTHONPATH=src python -m repro_torch.analysis.profile --train
        [--model granite-moe-3b-a800m|xlstm-1.3b] [--mode hier|naive]
        [--layers N]
        [--topology 2x4|2x(2x2)]

SUMMA: for each scheme, one warm-up run, then one profiled run of the whole
multiply (all rounds, ``use_kernel=True``), with the device ms of its
phases (the ``summa::*`` spans of ``apps.summa``: ``blocks``, ``a_panel``,
``b_panel``, ``accumulate``, each timed on the card by ``core.spans``).
``--ag-matmul``: the same for ``ag_matmul(use_kernel=True)`` at the width
of ``mistral-nemo-12b``'s MLP down-projection (K = d_ff = 14336, N =
d_model = 5120, 2048 tokens per rank, 1x8 cluster), exact and
``precision="lossy"`` (the q4 kernel).
``--serve``: ``--model`` (``qwen3-0.6b`` by default, or any ported
config: ``recurrentgemma-9b``, ``granite-moe-3b-a800m``, ``xlstm-1.3b``)
at full width (f32, random weights): one prefill of 8 slots x 2048 tokens
(s_max 4096), then one decode step of the 8 slots at position 2048, each
with the share of device time in the flash-attention and lru_scan
kernels.  ``--train``: ``--model``'s cluster train step
(``runtime.steps``) at full width — full depth unless ``--layers`` cuts
it — in ``--mode`` on the stacked ``--topology``, global batch 8 x 2048
tokens: one warm-up step, then one profiled step, with the shares of the
flash forward and backward kernels and of the f32 matrix products, the
device ms of the step's phases (the ``train::*`` spans of
``runtime.steps``: ``forward_backward`` per memory domain, ``bridge``,
``optimizer``), and on a topology with a tp axis (``2x(2x2)``) the device
time of the tp collectives: the ``tp::*`` spans of their forwards
(``ParallelCtx``) and their backward nodes, each span's kernels counted
once.  An MoE
model adds the device time of its block's parts (``MOE_RANGES``: routing
and tables, dispatch, the expert products, combine, and the gathers'
and the grouped expert products' backward nodes); an xLSTM model that of its blocks' parts
(``XLSTM_RANGES``: ``xlstm::mlstm_intra``, ``xlstm::mlstm_prefix``,
``xlstm::mlstm_decode``, ``xlstm::slstm_loop``).  Prints each run's wall
time, the device busy time (the union of every kernel and copy interval on
the card, so overlapping streams count once; a user-scope profiler range's
mirror on the device timeline, a ``gpu_user_annotation``, is no device
activity and is left out, as torch's own tables leave it), the busy share
of the wall time, and the kernels that took most device time.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.apps import summa
from repro_torch.comm import Communicator
from repro_torch.core import spans
from repro_torch.substrate import VirtualCluster


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_scheme(a, b, scheme: str, chunks: int, top: int = 5) -> dict:
    def run():
        return summa.summa(a, b, scheme=scheme, use_kernel=True,
                           chunks=chunks)
    return {"scheme": scheme, **profile_run(run, top)}


#: Profiler ranges (CPU events) whose device work is the tp collectives:
#: the forwards' ``tp::*`` ranges and the substrate Functions' backward
#: nodes.
TP_RANGES = ("tp::", "_AllGatherFnBackward", "_PsumScatterFnBackward",
             "_PsumFnBackward")
#: The MoE block's parts (``models.moe``): its ``moe::*`` ranges and the
#: dispatch / combine gathers' backward nodes.
MOE_RANGES = ("moe::", "_DispatchBackward", "_RowGatherBackward",
              "GroupedMatmulBackward")
#: The xLSTM blocks' parts (``models.xlstm``): the mLSTM's intra-chunk
#: products and chunk summaries, its cross-chunk prefix loop, its decode
#: step, and the sLSTM's time loop (forwards; a remat's recompute runs
#: them again inside the backward).
XLSTM_RANGES = ("xlstm::",)


def model_ranges(cfg) -> tuple:
    """The block-part ranges a model's profile reads."""
    kinds = set(cfg.pattern) | set(cfg.remainder_kinds)
    return ((MOE_RANGES if cfg.moe else ())
            + (XLSTM_RANGES if kinds & {"mlstm", "slstm"} else ()))


def _device_us(e) -> float:
    """A CPU event's device time, its children's kernels included."""
    return getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0.0)


def _ranges_ms(events, parts: tuple) -> tuple[dict, dict]:
    """Device ms and host (wall) ms under each CPU event whose name holds
    one of ``parts``, by name; an event nested inside a counted one is not
    counted again."""
    hits = [e for e in events if e.device_type == DeviceType.CPU
            and any(p_ in e.name for p_ in parts)]
    ids = {id(e) for e in hits}
    dev: dict[str, float] = defaultdict(float)
    wall: dict[str, float] = defaultdict(float)
    for e in hits:
        up, nested = e.cpu_parent, False
        while up is not None:
            if id(up) in ids:
                nested = True
                break
            up = up.cpu_parent
        if not nested:
            name = e.name.split(": ")[-1]
            dev[name] += _device_us(e) / 1e3
            wall[name] += e.time_range.elapsed_us() / 1e3
    return dict(dev), dict(wall)


def profile_run(run, top: int = 5, ranges: tuple = ()) -> dict:
    """One warm-up call of ``run``, then one profiled call; with
    ``ranges``, the device ms and the host ms under the CPU events those
    name parts match (``_ranges_ms``: ``ranges`` and ``ranges_wall``);
    ``spans``, the profiled call's ``core.spans.totals()``."""
    run()
    torch.cuda.synchronize()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity: "
                           "device time not measured")
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev]) / 1e3
    by_name: dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    rng = _ranges_ms(events, ranges) if ranges else ({}, {})
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "top": ranked[:top],
            "all": ranked, "launches": len(dev),
            "ranges": rng[0], "ranges_wall": rng[1],
            "spans": spans.totals()}


def _print(label: str, r: dict) -> None:
    print(f"[profile] {label:9s}: wall {r['wall_ms']:.1f} ms  device "
          f"busy {r['busy_ms']:.1f} ms ({100 * r['busy_share']:.1f}%), "
          f"{r['launches']} device activities")
    for name, ms in r["top"]:
        print(f"[profile]    {ms:9.2f} ms  {name[:90]}")


def _print_spans(r: dict, prefix: str, what: str) -> None:
    """The device ms and calls of the profiled call's ``prefix`` spans."""
    hit = {k: v for k, v in r["spans"].items() if k.startswith(prefix)}
    print(f"[profile]    {what}: " + (", ".join(
        f"{k} {v['ms']:.2f} ms ({v['calls']} calls)"
        for k, v in sorted(hit.items(), key=lambda kv: -kv[1]["ms"]))
        or "no span timed"))


def profile_ag_matmul(dev: torch.device, chunks: int) -> None:
    """Exact vs lossy ``ag_matmul`` at ``mistral-nemo-12b`` w_out width."""
    d_model, d_ff, tokens = 5120, 14336, 2048
    vc = VirtualCluster(pods=1, chips=8, device=dev)
    comm = Communicator.from_cluster(vc)
    g = torch.Generator(device=dev).manual_seed(0)
    w_shard = torch.randn((vc.chips, d_ff // vc.chips, d_model),
                          generator=g, device=dev)
    x = torch.randn((vc.num_devices, tokens, d_ff), generator=g, device=dev)
    print(f"{torch.cuda.get_device_name(0)}; ag_matmul K={d_ff} N={d_model} "
          f"{tokens} tokens/rank f32 on 1x8, use_kernel=True, "
          f"chunks={chunks}")
    with vc.bind():
        for precision in ("exact", "lossy"):
            _print(precision, profile_run(lambda: comm.ag_matmul(
                x, w_shard, n_chunks=chunks, use_kernel=True,
                precision=precision)))


def profile_serve(dev: torch.device, name: str, top: int = 8) -> None:
    """Prefill and one decode step of the full-width model ``name``."""
    from repro_torch.configs import get_config
    from repro_torch.models import ParallelCtx, build
    cfg = get_config(name)
    model = build(cfg, ParallelCtx.single(), device=dev)
    params = model.init_params(0)
    B, T, s_max = 8, 2048, 4096
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T + 1), generator=g,
                                     device=dev, dtype=torch.int32)}
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} full width f32, "
          f"prefill {B} x {T} (s_max {s_max}), then one decode step")
    cache = {}

    def prefill():
        cache["c"] = model.prefill_fn(params, batch, s_max)[0]

    ranges = model_ranges(cfg)
    r = profile_run(prefill, top, ranges)
    _print("prefill", r)
    _print_share(r)
    tok = batch["tokens"][:, -1:]
    pos = torch.full((B,), T, dtype=torch.int32, device=dev)
    r = profile_run(lambda: model.decode_fn(params, cache["c"], tok, pos),
                    top, ranges)
    _print("decode", r)
    _print_share(r)


def profile_train(dev: torch.device, mode: str, topology: str,
                  layers: int, top: int = 10,
                  name: str = "qwen3-0.6b") -> None:
    """One step of ``name``'s cluster train step at full width."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.runtime.steps import make_cluster_train_step
    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    vc = VirtualCluster.from_label(topology, device=dev)
    bundle = make_cluster_train_step(cfg, vc, mode=mode, global_batch=8)
    state = bundle.init_layout_state(0)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = bundle.layout_batch({"tokens": torch.randint(
        0, cfg.vocab, (8, 2049), generator=g, device=dev,
        dtype=torch.int32)})
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} full width, "
          f"{cfg.n_layers} layers, f32, {mode} on {vc.label}, train step "
          f"of 8 x 2048 tokens")

    def step():
        bundle.step(state, batch)

    tp = bundle.model.ctx.tp_axis is not None
    r = profile_run(step, top, (TP_RANGES if tp else ()) + model_ranges(cfg))
    _print("train", r)
    _print_spans(r, "train::", "step phases")
    _print_share(r)
    if tp:
        _print_ranges(r, TP_RANGES, "tp collectives")


def _print_ranges(r: dict, parts: tuple, what: str) -> None:
    """The device ms of the profiled ranges ``parts`` match, and their
    share of the device busy time."""
    hit = {k: v for k, v in r["ranges"].items()
           if any(p_ in k for p_ in parts)}
    total = sum(hit.values())
    print(f"[profile]    {what} {total:.2f} ms = "
          f"{100 * total / r['busy_ms']:.1f}% of device busy time: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              hit.items(), key=lambda kv: -kv[1])))


#: The port's kernels (and the library's f32 products) by parts of their
#: device names.
KERNELS = {"flash_attention": ("flash_fwd",),
           "flash_attention_bwd": ("flash_bwd", "prep<"),
           "lru_scan": ("lru_scan_kernel",),
           "f32 matrix products (cuBLAS)": ("gemm", "gemv")}


def _print_share(r: dict) -> None:
    if any(k.startswith(MOE_RANGES) for k in r["ranges"]):
        _print_ranges(r, MOE_RANGES, "MoE block parts")
    if any(k.startswith(XLSTM_RANGES) for k in r["ranges"]):
        _print_ranges(r, XLSTM_RANGES, "xLSTM block parts")
    for kernel, parts in KERNELS.items():
        hits = [ms for name, ms in r["all"]
                if any(part in name for part in parts)]
        print(f"[profile]    {kernel} kernel {sum(hits):.2f} ms = "
              f"{100 * sum(hits) / r['busy_ms']:.1f}% of device busy time"
              + ("" if hits else " (not launched)"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--ag-matmul", action="store_true",
                    help="profile exact vs lossy ag_matmul instead of SUMMA")
    ap.add_argument("--serve", action="store_true",
                    help="profile a full-width model's prefill and decode")
    ap.add_argument("--model", default="qwen3-0.6b",
                    help="the model --serve / --train profiles")
    ap.add_argument("--train", action="store_true",
                    help="profile a full-width model's cluster train step")
    ap.add_argument("--mode", default="hier", choices=["hier", "naive"])
    ap.add_argument("--topology", default="2x4")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth for --train (0: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.ag_matmul:
        profile_ag_matmul(dev, args.chunks)
        return
    if args.serve:
        profile_serve(dev, args.model)
        return
    if args.train:
        profile_train(dev, args.mode, args.topology, args.layers,
                      name=args.model)
        return
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((args.n, args.n), generator=g, device=dev)
    b = torch.randn((args.n, args.n), generator=g, device=dev)
    print(f"{torch.cuda.get_device_name(0)}; SUMMA N={args.n} f32, 4x4 grid, "
          f"use_kernel=True, chunks={args.chunks}")
    for scheme in summa.SCHEMES:
        r = profile_scheme(a, b, scheme, args.chunks)
        _print(scheme, r)
        _print_spans(r, "summa::", "phases")


if __name__ == "__main__":
    main()
