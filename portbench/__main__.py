"""Run one cell of the port's benchmark once, on the card.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``src/`` is put on the path).  The last line
of standard output is the result as one JSON object; the numbers compared
with the reference close standard error, each beside its limit.  Without a
CUDA card, or with fewer than the cell asks for, it exits 1 and prints no
result; so it does if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _prepare_env() -> None:
    """``src/`` on the path and every kernel cache at a fixed place inside
    the checkout (the port builds its own kernels in ``src/repro_torch/
    _build``)."""
    src = ROOT / "src"
    if src.is_dir() and str(src) not in sys.path:
        sys.path.insert(0, str(src))
    cache = ROOT / "portbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_env()

    import torch

    from portbench import harness
    t_import = time.perf_counter()

    try:
        cell = harness.find_cell(harness.load_manifest(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result (a CPU run measures no device)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    harness.log(f"imports {t_import - T_START:.3f} s, card ready "
                f"{time.perf_counter() - T_START:.3f} s")
    result, checks = harness.run_cell(cell, seed=args.seed,
                                      seconds=args.seconds,
                                      trace=bool(args.trace),
                                      device=device, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the benchmark measures "
              "the port alone; no result", file=sys.stderr)
        return 1
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
