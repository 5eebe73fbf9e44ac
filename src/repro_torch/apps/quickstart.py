"""Quickstart: train a tiny qwen3-family model on synthetic data and watch
the loss fall well below ln(vocab); then generate from it.

The counterpart of the reference's ``examples/quickstart.py``: the reduced
``qwen3-0.6b`` (2 layers, d 128, 4 heads, vocab 512) through
``runtime.steps.make_train_step`` on the single-device topology
``{"data": 1, "model": 1}`` (``launch.mesh.make_mesh_from_topo``), 60 steps
of 8 x 128 synthetic tokens at lr 3e-3, then ``greedy_generate`` of 8
tokens for two 32-token prompts with the single-device model on the trained
parameters (the ``{"data": 1, "model": 1}`` layout is the single-device
one).

    PYTHONPATH=src python -m repro_torch.apps.quickstart [--steps 60]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.topology import MeshTopology
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh_from_topo
from repro_torch.models import ParallelCtx, build
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train_loop import train
from repro_torch.serving.engine import greedy_generate


def config():
    return get_config("qwen3-0.6b").reduced(n_layers=2, d_model=128,
                                            n_heads=4, vocab=512)


def make_bundle(device="cuda"):
    """The quickstart's train step: the single-device topology, lr 3e-3,
    f32."""
    topo = MeshTopology({"data": 1, "model": 1}, slow_axes=())
    mesh = make_mesh_from_topo(topo, device=device)
    return make_train_step(config(), topo, mesh, mode="hier", lr=3e-3,
                           compute_dtype=torch.float32)


def run(steps: int = 60, device="cuda", log_every: int = 10):
    """Train ``steps`` steps from seed 0's draw and generate; returns
    ``(report, generated)``."""
    cfg = config()
    bundle = make_bundle(device)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8)
    report = train(bundle, steps=steps, data_cfg=data_cfg,
                   log_every=log_every)
    base = np.log(cfg.vocab_padded)
    print(f"\nfinal loss {report.final_loss:.3f} vs ln(V)={base:.3f} "
          f"(structure learned: {report.final_loss < base - 0.5})")

    # generate with the serving engine from the trained params (the
    # single-device ctx shares the exact param layout at tp=1)
    model1 = build(cfg, ParallelCtx.single(), device=device)
    params = bundle.unlayout_state(report.state)["params"]
    prompts = SyntheticLM(data_cfg).next_batch()["tokens"][:2, :32] \
        .astype(np.int32)
    res = greedy_generate(model1, params, prompts, max_new=8)
    print("generated:", res.tokens.tolist())
    return report, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train a tiny qwen3 on "
                                             "synthetic data, then generate")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is visible "
                         "(pass --device cpu)")
    run(args.steps, torch.device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
