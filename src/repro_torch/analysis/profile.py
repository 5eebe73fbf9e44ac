"""Where the time goes on the card: SUMMA under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.analysis.profile [--n 16384]
        [--chunks 2]

For each scheme: one warm-up run, then one profiled run of the whole SUMMA
(all rounds, ``use_kernel=True``).  Prints the run's wall time, the device
busy time (the union of every kernel and copy interval on the card, so
overlapping streams count once), the busy share of the wall time, and the
kernels that took most device time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.apps import summa


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

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity: "
                           "device time not measured")
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev]) / 1e3
    by_name: dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"scheme": scheme, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "top": ranked}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--chunks", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((args.n, args.n), generator=g, device=dev)
    b = torch.randn((args.n, args.n), generator=g, device=dev)
    print(f"{torch.cuda.get_device_name(0)}; SUMMA N={args.n} f32, 4x4 grid, "
          f"use_kernel=True, chunks={args.chunks}")
    for scheme in summa.SCHEMES:
        r = profile_scheme(a, b, scheme, args.chunks)
        print(f"[profile] {scheme:9s}: wall {r['wall_ms']:.1f} ms  device "
              f"busy {r['busy_ms']:.1f} ms ({100 * r['busy_share']:.1f}%)")
        for name, ms in r["top"]:
            print(f"[profile]    {ms:9.2f} ms  {name[:90]}")


if __name__ == "__main__":
    main()
