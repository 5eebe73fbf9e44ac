"""SUMMA distributed matmul (paper §5.2.1) — hybrid vs naive broadcasts.

The process grid is (nodes x cores) = (4, 4), stacked on one device.  Each
SUMMA round broadcasts an A-panel along the grid row (inside a node) and a
B-panel down the grid column (over the bridge):

* naive  (pure MPI, Ori_SUMMA): every core ends with a private panel copy;
* hybrid (paper, Hy_SUMMA): ONE shared panel copy per node, sharded over
  the node's cores (a ``SharedWindow``), read at use;
* pipelined (Hy_SUMMA + compute overlap): the same shared panel window, but
  the read is fused into the panel product (``Communicator.ag_matmul_rows``)
  so the window load streams behind the per-chunk matmuls;
* auto: ``scheme="auto"`` picks the row-panel reduction scheme from the
  ``core.plans`` closed forms.

All schemes must give C = A @ B.  ``--use-kernel`` routes every panel
product through the Hopper kernel (one batched launch covers all 16 ranks'
products of a round).  The per-round traffic lines come from ``core.plans``.

    PYTHONPATH=src python -m repro_torch.apps.summa [--n 512] [--use-kernel]
        [--chunks 2] [--device cuda|cpu] [--seed 0]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.comm import Communicator, SharedWindow, registry, tuning
from repro_torch.comm import primitives as p
from repro_torch.core.plans import broadcast_traffic
from repro_torch.core.spans import span
from repro_torch.kernels import ops
from repro_torch.substrate import VirtualCluster
from repro_torch.substrate import collectives as coll

NODES, CORES = 4, 4   # grid rows = nodes (fast tier inside a row)
SCHEMES = ("naive", "hybrid", "pipelined", "auto")
# a grid row is one shared-memory node: cores exchange panels in-node
ROW_COMM = Communicator(fast_axis="core", slow_axis=None, pods=1,
                        chips=CORES)


def grid(device) -> VirtualCluster:
    return VirtualCluster(pods=NODES, chips=CORES, fast_axis="core",
                          slow_axis="node", device=device)


def to_blocks(m: torch.Tensor) -> torch.Tensor:
    """(N, N) -> (R, N/NODES, N/CORES): rank (i, j) holds block [i, j]."""
    N = m.shape[0]
    return m.reshape(NODES, N // NODES, CORES, N // CORES).transpose(1, 2) \
        .reshape(NODES * CORES, N // NODES, N // CORES)


def from_blocks(c: torch.Tensor) -> torch.Tensor:
    N = c.shape[1] * NODES
    return c.reshape(NODES, CORES, N // NODES, N // CORES).transpose(1, 2) \
        .reshape(N, N)


def summa(a: torch.Tensor, b: torch.Tensor, *, scheme: str,
          use_kernel: bool = False, chunks: int = 2) -> torch.Tensor:
    """C = A @ B for (N, N) ``a``, ``b`` on one device, by SUMMA rounds."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; pick from {SCHEMES}")
    N = a.shape[0]
    if a.shape != (N, N) or b.shape != (N, N) or N % (NODES * CORES):
        raise ValueError(f"SUMMA needs square (N, N) operands with N a "
                         f"multiple of {NODES * CORES}, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    mm = ops.matmul if use_kernel else torch.matmul
    with span("summa::multiply"), grid(a.device).bind():
        i, j = p.axis_index("node"), p.axis_index("core")
        with span("summa::blocks"):
            a_blk, b_blk = to_blocks(a), to_blocks(b)
            cs = torch.zeros((NODES * CORES, N // NODES, N // CORES),
                             dtype=torch.float32, device=a.device)
        for k in range(CORES):          # SUMMA rounds over the inner grid dim
            with span("summa::a_panel"):
                a_src = p._select(j == k, a_blk)    # row bcast of A[:, k]
                if scheme == "pipelined":
                    win = ROW_COMM.reduce_scatter(a_src, scheme="shared")
                elif scheme == "naive":
                    # raw-collective: pedagogical SUMMA baseline
                    a_panel = coll.psum(a_src, "core")
                elif scheme == "hybrid":
                    # one shared panel per node, read at use
                    a_panel = ROW_COMM.reduce_scatter(a_src,
                                                      scheme="shared").read()
                else:
                    out = ROW_COMM.allreduce(a_src, scheme="auto")
                    a_panel = out.read() if isinstance(out, SharedWindow) \
                        else out
            with span("summa::b_panel"):
                b_src = p._select(i == k, b_blk)    # column bcast of B[k, :]
                # raw-collective: pedagogical SUMMA baseline, raw by design
                b_panel = coll.psum(b_src, "node")  # the bridge tier
            if scheme == "pipelined":   # the window read overlaps the product
                prod = ROW_COMM.ag_matmul_rows(win.shard, b_panel,
                                               n_chunks=chunks,
                                               use_kernel=use_kernel)
            else:
                prod = mm(a_panel, b_panel)
            with span("summa::accumulate"):
                cs += prod
            del prod
        with span("summa::blocks"):
            return from_blocks(cs).to(a.dtype)


def round_traffic(scheme: str, n: int, resolved: str):
    """Per-round broadcast traffic of one scheme's A-panel (``core.plans``);
    ``resolved`` is the scheme ``auto`` picked."""
    flat = scheme == "naive" or (
        scheme == "auto"
        and registry.get_scheme(resolved).result_class == "replicated")
    return broadcast_traffic(scheme="naive" if flat else "hier",
                             num_nodes=NODES, ranks_per_node=CORES,
                             msg_bytes=n * (n // CORES) * 4)


def traffic_line(scheme: str, n: int, resolved: str) -> str:
    tr = round_traffic(scheme, n, resolved)
    panel = n * (n // CORES) * 4  # bytes per A panel
    return (f"intra-node copy bytes/round={tr.fast_bytes:,}  "
            f"panel copies/node={tr.result_bytes_per_node // panel}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--chunks", type=int, default=2,
                    help="overlap depth of the pipelined variant")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    a = torch.randn((args.n, args.n), generator=g, device=device)
    b = torch.randn((args.n, args.n), generator=g, device=device)
    want = torch.matmul(a, b)

    panel_elems = (args.n // NODES) * (args.n // CORES)
    res = tuning.resolve_for(ROW_COMM, "psum", elems=panel_elems)
    print(f"scheme='auto' resolved the row-panel reduction to "
          f"{res.scheme!r} [{res.source}] for this 1x{CORES} node shape")
    for scheme in SCHEMES:
        t0 = time.perf_counter()
        got = summa(a, b, scheme=scheme, use_kernel=args.use_kernel,
                    chunks=args.chunks)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        err = ((got - want).abs().max() / want.abs().max()).item()
        print(f"{scheme:9s}: {dt * 1e3:8.1f} ms  rel_err={err:.2e}  "
              f"{traffic_line(scheme, args.n, res.scheme)}")
    print("paper claim C2: the hybrid schemes delete all intra-node panel "
          "copies; all schemes match A@B.")


if __name__ == "__main__":
    main()
