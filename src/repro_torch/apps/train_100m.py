"""End to end: train a ~150M-param qwen3-family model with checkpoint /
restart.

The counterpart of the reference's ``examples/train_100m.py``: 12 layers,
d 768, 12 q / 4 kv heads of 64, d_ff 3072, vocab 32768, through
``runtime.steps.make_train_step`` on the single-device topology
``{"data": 1, "model": 1}`` at lr 6e-4, saving every ``--save-every``
steps under ``--ckpt``.  Kill it mid-run and re-invoke: it resumes from the
last checkpoint with the data stream fast-forwarded, so the loss curve
continues as if uninterrupted (``resumed_from`` in the last line).
``--n-layers`` / ``--d-model`` / ``--vocab`` cut the model (a smoke run).

    PYTHONPATH=src python -m repro_torch.apps.train_100m --steps 300 \\
        [--ckpt DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.topology import MeshTopology
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch.mesh import make_mesh_from_topo
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train_loop import train


def config(n_layers: int = 12, d_model: int = 768, vocab: int = 32768):
    """The reference's 150M config (``d_model`` / ``n_layers`` / ``vocab``
    cut it; heads of 64, kv heads a third of the q heads, d_ff 4 d)."""
    n_heads = max(1, d_model // 64)
    return dataclasses.replace(
        get_config("qwen3-0.6b"), name="qwen3-150m", n_layers=n_layers,
        d_model=d_model, n_heads=n_heads, n_kv=max(1, n_heads // 3),
        head_dim=64, d_ff=4 * d_model, vocab=vocab)


def main(argv=None):
    ap = argparse.ArgumentParser(description="train a ~150M qwen3 with "
                                             "checkpoint / restart")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="checkpoints/train_100m")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--n-layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is visible "
                         "(pass --device cpu)")
    cfg = config(args.n_layers, args.d_model, args.vocab)
    print(f"params: {cfg.param_count() / 1e6:.0f}M")

    topo = MeshTopology({"data": 1, "model": 1}, slow_axes=())
    mesh = make_mesh_from_topo(topo, device=torch.device(args.device))
    bundle = make_train_step(cfg, topo, mesh, mode="hier", lr=6e-4,
                             compute_dtype=torch.float32)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    report = train(bundle, steps=args.steps, data_cfg=data_cfg,
                   ckpt_dir=args.ckpt, save_every=args.save_every,
                   log_every=10)
    base = float(np.log(cfg.vocab_padded))
    print(f"final loss {report.final_loss:.3f} (ln V = {base:.3f}); "
          f"resumed_from={report.resumed_from}")
    return report


if __name__ == "__main__":
    main()
