#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device

Phases (any failed check raises, and the script exits nonzero):

1. device and build: the card's name and power limit (``nvidia-smi``), then
   the Hopper panel-matmul kernel built from ``src/repro_torch/csrc``;
2. kernel: ``ops.matmul`` (the kernel) against its plain version on the
   card — f32 and bf16 at 4096^3 and the ragged (96, 160, 224), and at the
   SUMMA round's batched shape (16 ranks x 4096^3, f32), timed beside the
   plain version and ``torch.matmul``;
3. collectives: every primitive over ``default_matrix()`` at 2^20 f32
   elements per rank — values agree across schemes, the traffic record
   prices to each scheme's ``links()``, and the measured resident result
   bytes per node give naive/shared = ranks_per_node (C1);
4. SUMMA: N = 16384 f32 on the 4x4 grid, all four schemes through the
   kernel, each within rel_err 1e-5 of ``torch.matmul``;
5. BPMF: the 2x4 grid at the MovieLens-1M shape (6040 users x 3704 items,
   4.5% observed, D = 16, 10 sweeps) — naive and hybrid give identical
   predictions and the held-out RMSE beats the zero predictor.

Kernel launch counts are zeroed just before phases 3-5 (the main path) and
read just after.  The line before the last is a JSON ``kernels`` record;
the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up
    (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(got, want, dtype, K: int, what: str) -> float:
    """The reference kernel tests' tolerance (F32 2e-4 / BF16 2e-2, rtol
    K-scaled, atol x8), compared in fp32; returns max |err|."""
    import torch
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    rtol, atol = tol * max(1, K // 256 + 1), tol * 8
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = (err > atol + rtol * w.abs()).sum().item()
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{what}: {bad} elements outside rtol={rtol} "
                             f"atol={atol} (max |err| {err.max().item()})")
    return err.max().item()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.analysis import traffic
    from repro_torch.apps import bpmf, summa
    from repro_torch.kernels import matmul as kmatmul
    from repro_torch.kernels import ops
    from repro_torch.substrate import default_matrix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    # -- 1. device and build ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = kmatmul.library()
    print(f"[build] {lib.path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {lib.build_seconds:.1f} s)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # -- 2. kernel vs its plain version ----------------------------------------
    t_phase = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N in ((4096, 4096, 4096), (96, 160, 224)):
            a = torch.randn((M, K), generator=g, device=dev).to(dtype)
            b = torch.randn((K, N), generator=g, device=dev).to(dtype)
            got = ops.matmul(a, b)
            torch.cuda.synchronize()
            err = check_close(got, kmatmul.matmul_plain(a, b), dtype, K,
                              f"matmul {dtype} {M}x{K}x{N}")
            line = f"[kernel] {str(dtype)[6:]:8s} {M}x{K}x{N}: " \
                   f"max|err| {err:.3g}"
            if M == 4096:
                line += (f"  kernel {cuda_ms(lambda: ops.matmul(a, b), 5):.3f}"
                         f" ms  plain "
                         f"{cuda_ms(lambda: kmatmul.matmul_plain(a, b), 5):.3f}"
                         f" ms  torch.matmul "
                         f"{cuda_ms(lambda: torch.matmul(a, b), 5):.3f} ms")
            print(line)
    # the main path's shape: one SUMMA round = 16 rank panels of 4096^3 f32
    B, M = summa.NODES * summa.CORES, 4096
    a = torch.randn((B, M, M), generator=g, device=dev)
    b = torch.randn((B, M, M), generator=g, device=dev)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    main_err = check_close(got, kmatmul.matmul_plain(a, b), torch.float32,
                           M, "matmul f32 16x4096^3")
    del got
    k_ms = cuda_ms(lambda: ops.matmul(a, b), 3)
    plain_ms = cuda_ms(lambda: kmatmul.matmul_plain(a, b), 3)
    lib_ms = cuda_ms(lambda: torch.matmul(a, b), 3)
    flops = 2.0 * B * M * M * M
    moved = 3.0 * B * M * M * 4                 # A, B read once, C written
    ops_ms, bytes_ms = flops / 67e12 * 1e3, moved / 3.35e12 * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"[kernel] f32 {B}x{M}^3 (SUMMA round): max|err| {main_err:.3g}  "
          f"kernel {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s)  plain "
          f"{plain_ms:.3f} ms  torch.matmul {lib_ms:.3f} ms  bound "
          f"{bound_ms:.3f} ms ({'operations' if ops_ms >= bytes_ms else 'bytes'})")
    del a, b
    print(f"[phase] kernel {time.perf_counter() - t_phase:.1f} s")

    # -- main path: zero the counts, drive phases 3-5, read them -----------------
    kmatmul.launches = 0

    # -- 3. collectives over the topology matrix --------------------------------
    t_phase = time.perf_counter()
    for vc in default_matrix(device=dev):
        rows = traffic.check_matrix(vc, elems=2 ** 20)
        ratios = traffic.c1_ratios(rows)
        for fam in ("allgather", "broadcast", "psum"):
            if vc.chips > 1 and ratios[(vc.label, fam)] != vc.chips:
                raise AssertionError(f"C1 {vc.label}/{fam}: naive/shared "
                                     f"{ratios[(vc.label, fam)]} != "
                                     f"{vc.chips}")
        ag = {r.scheme: r.node_bytes for r in rows
              if r.family == "allgather"}
        print(f"[collectives] {vc.label}: {len(rows)} cases agree, traffic "
              f"== links(); allgather result bytes/node naive "
              f"{ag['naive']:.0f} shared {ag['shared']:.0f} (ratio "
              f"{ratios[(vc.label, 'allgather')]:g})")
    torch.cuda.synchronize()
    print(f"[phase] collectives {time.perf_counter() - t_phase:.1f} s")

    # -- 4. SUMMA -----------------------------------------------------------------
    t_phase = time.perf_counter()
    n = 16384
    A = torch.randn((n, n), generator=g, device=dev)
    Bm = torch.randn((n, n), generator=g, device=dev)
    want = torch.matmul(A, Bm)
    scale = want.abs().max()
    resolved = summa.tuning.resolve_for(
        summa.ROW_COMM, "psum", elems=(n // summa.NODES) * (n // summa.CORES))
    for scheme in summa.SCHEMES:
        before = kmatmul.launches
        got = summa.summa(A, Bm, scheme=scheme, use_kernel=True, chunks=2)
        rel = ((got - want).abs().max() / scale).item()
        grew = kmatmul.launches - before
        del got
        torch.cuda.synchronize()        # the second run is the timed one
        t0 = time.perf_counter()
        summa.summa(A, Bm, scheme=scheme, use_kernel=True, chunks=2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"[summa] {scheme:9s}: {ms:9.1f} ms  rel_err={rel:.2e}  "
              f"kernel launches {grew}  "
              f"{summa.traffic_line(scheme, n, resolved.scheme)}")
        if not rel <= 1e-5:
            raise AssertionError(f"SUMMA {scheme}: rel_err {rel} > 1e-5")
        if grew <= 0:
            raise AssertionError(f"SUMMA {scheme}: the kernel never ran")
        copies = summa.round_traffic(scheme, n, resolved.scheme).fast_bytes
        if scheme in ("hybrid", "pipelined") and copies:
            raise AssertionError(f"SUMMA {scheme}: {copies} intra-node "
                                 "copy bytes per round, expected 0")
    del A, Bm, want
    print(f"[phase] summa {time.perf_counter() - t_phase:.1f} s")

    # -- 5. BPMF ------------------------------------------------------------------
    t_phase = time.perf_counter()
    r_obs, mask, r, test = bpmf.synthetic(6040, 3704, 0.045, 0, dev)
    base = bpmf.rmse(torch.zeros_like(r), r, test)
    preds = {}
    for scheme in bpmf.SCHEMES:
        preds[scheme] = bpmf.bpmf(r_obs, mask, scheme, iters=10, seed=0)
        torch.cuda.synchronize()        # the second run is the timed one
        t0 = time.perf_counter()
        again = bpmf.bpmf(r_obs, mask, scheme, iters=10, seed=0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = bpmf.rmse(preds[scheme], r, test)
        print(f"[bpmf] {scheme:6s}: {ms:9.1f} ms  RMSE {err:.4f} "
              f"(zero predictor {base:.4f})")
        if not err < base or not torch.isfinite(preds[scheme]).all():
            raise AssertionError(f"BPMF {scheme}: RMSE {err} not below "
                                 f"the baseline {base}")
        if not torch.equal(again, preds[scheme]):
            raise AssertionError(f"BPMF {scheme}: a rerun with the same "
                                 "seed gave other predictions")
        del again
    if not torch.equal(preds["naive"], preds["hybrid"]):
        raise AssertionError("BPMF: naive and hybrid predictions differ")
    print(f"[phase] bpmf {time.perf_counter() - t_phase:.1f} s")

    launches = kmatmul.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the matmul kernel")
    print(json.dumps({"kernels": [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:33",
        "launches": launches, "max_abs_err": main_err, "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
