"""BPMF — Bayesian Probabilistic Matrix Factorization (paper §5.2.2).

Gibbs sampling over user/item factors on a two-tier grid (2 nodes x 4
cores) stacked on one device.  Each iteration samples the user factors
(needs ALL item factors) then the item factors (needs ALL user factors) —
the two all-gathers the paper accelerates:

* naive  (Ori_BPMF): flat allgather, every core a private copy of the full
  factor matrix;
* hybrid (Hy_BPMF): bridge-only exchange (``shared`` allgather), one copy
  per node sharded over its cores, read at use;
* auto: ``scheme="auto"`` picks the gather scheme for the 2x4 shape.

Every variant draws the same Gibbs noise from one seeded
``torch.Generator``, so the variants give identical predictions; the
held-out RMSE falls below the zero predictor's.

    PYTHONPATH=src python -m repro_torch.apps.bpmf [--iters 10]
        [--users 128] [--items 128] [--density 0.3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.comm import Communicator, SharedWindow, registry, tuning
from repro_torch.core.plans import allgather_traffic
from repro_torch.substrate import VirtualCluster

NODES, CORES = 2, 4
RANKS = NODES * CORES
SCHEMES = ("naive", "hybrid", "auto")
COMM = Communicator(fast_axis="core", slow_axis="node", pods=NODES,
                    chips=CORES)
D = 16           # latent dim
BETA = 100.0     # observation precision (matches noise sd 0.1)
LAM = 16.0       # prior precision (= D, the BPMF default scale)


def grid(device) -> VirtualCluster:
    return VirtualCluster(pods=NODES, chips=CORES, fast_axis="core",
                          slow_axis="node", device=device)


def gather(x: torch.Tensor, scheme: str) -> torch.Tensor:
    """Allgather factor shards: (R, n_loc, D) -> (R, N, D), rank order."""
    if scheme == "naive":
        return COMM.allgather(x, scheme="naive")
    if scheme == "auto":
        out = COMM.allgather(x, scheme="auto")
        return out.read_rank_order() if isinstance(out, SharedWindow) \
            else out
    # hybrid: ONE shared copy per node (a SharedWindow), read at use
    return COMM.allgather(x, scheme="shared").read_rank_order()


def sample_factors(r_loc, mask_loc, other_full, noise):
    """Posterior sample for each rank's rows given the other factor matrix.
    r_loc, mask_loc: (R, n_loc, M); other_full: (R, M, D); noise:
    (R, n_loc, D) standard normal."""
    R, n_loc, M = r_loc.shape
    outer = (other_full.unsqueeze(-1) * other_full.unsqueeze(-2)) \
        .reshape(R, M, D * D)
    eye = torch.eye(D, device=r_loc.device)
    prec = BETA * (mask_loc @ outer).reshape(R, n_loc, D, D) + LAM * eye
    cov = torch.linalg.inv(prec)
    rhs = (r_loc * mask_loc) @ other_full                  # (R, n_loc, D)
    mean = BETA * (cov @ rhs.unsqueeze(-1)).squeeze(-1)
    chol = torch.linalg.cholesky(cov)
    return mean + (chol @ noise.unsqueeze(-1)).squeeze(-1)


def bpmf(r: torch.Tensor, mask: torch.Tensor, scheme: str, iters: int,
         seed: int = 0) -> torch.Tensor:
    """Posterior-predictive mean (N, M) after ``iters`` Gibbs sweeps (the
    second half averaged).  ``r`` holds the observed ratings (zeros
    elsewhere), ``mask`` marks them."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; pick from {SCHEMES}")
    N, M = r.shape
    if N % RANKS or M % RANKS:
        raise ValueError(f"users {N} and items {M} must divide over "
                         f"{RANKS} ranks")
    dev = r.device
    r_u, m_u = r.reshape(RANKS, N // RANKS, M), mask.reshape(RANKS, -1, M)
    r_v = r.T.contiguous().reshape(RANKS, M // RANKS, N)
    m_v = mask.T.contiguous().reshape(RANKS, M // RANKS, N)
    g = torch.Generator(device=dev).manual_seed(seed)
    u = 0.1 * torch.randn((RANKS, N // RANKS, D), generator=g, device=dev)
    v = 0.1 * torch.randn((RANKS, M // RANKS, D), generator=g, device=dev)
    acc = torch.zeros((RANKS, N, M), device=dev)
    kept = 0
    with grid(dev).bind():
        for it in range(iters):
            v_full = gather(v, scheme)                            # (R, M, D)
            u = sample_factors(r_u, m_u, v_full, torch.randn(
                u.shape, generator=g, device=dev))
            u_full = gather(u, scheme)                            # (R, N, D)
            v = sample_factors(r_v, m_v, u_full, torch.randn(
                v.shape, generator=g, device=dev))
            if it >= iters // 2:     # posterior-predictive average
                acc += gather(u, scheme) @ gather(v, scheme).transpose(1, 2)
                kept += 1
    return acc[0] / max(kept, 1)


def synthetic(users: int, items: int, density: float, seed: int, device):
    """Low-rank ratings plus noise sd 0.1: (r_obs, mask, r_true,
    test_mask) with ``density`` observed and a tenth of the rest held out."""
    g = torch.Generator(device=device).manual_seed(seed)
    u_true = torch.randn((users, D), generator=g, device=device) / D ** 0.5
    v_true = torch.randn((items, D), generator=g, device=device) / D ** 0.5
    r = u_true @ v_true.T + 0.1 * torch.randn((users, items), generator=g,
                                              device=device)
    mask = (torch.rand(r.shape, generator=g, device=device) < density).float()
    test = (torch.rand(r.shape, generator=g, device=device) < 0.1).float() \
        * (1 - mask)
    return r * mask, mask, r, test


def rmse(pred: torch.Tensor, r: torch.Tensor, test: torch.Tensor) -> float:
    return (((pred - r) ** 2 * test).sum() / test.sum()).sqrt().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--users", type=int, default=128)
    ap.add_argument("--items", type=int, default=128)
    ap.add_argument("--density", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    r_obs, mask, r, test = synthetic(args.users, args.items, args.density,
                                     args.seed, device)
    base = rmse(torch.zeros_like(r), r, test)
    res = tuning.resolve_for(COMM, "allgather",
                             elems=args.items * D // RANKS)
    print(f"scheme='auto' resolved the factor gather to {res.scheme!r} "
          f"[{res.source}] on this {NODES}x{CORES} shape")
    preds = {}
    for scheme in SCHEMES:
        t0 = time.perf_counter()
        preds[scheme] = bpmf(r_obs, mask, scheme, args.iters, args.seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        flat = scheme == "naive" or (
            scheme == "auto"
            and registry.get_scheme(res.scheme).result_class == "replicated")
        tr = allgather_traffic(scheme="naive" if flat else "hier",
                               num_nodes=NODES, ranks_per_node=CORES,
                               bytes_per_rank=args.items * D * 4 // RANKS)
        print(f"{scheme:6s}: TT({args.iters} iters)={dt * 1e3:8.1f} ms  "
              f"RMSE={rmse(preds[scheme], r, test):.4f} (baseline "
              f"{base:.4f})  intra-node copy bytes/gather="
              f"{tr.fast_bytes:,}")
    for scheme in ("hybrid", "auto"):
        if not torch.equal(preds["naive"], preds[scheme]):
            raise SystemExit(f"{scheme} predictions differ from naive")


if __name__ == "__main__":
    main()
