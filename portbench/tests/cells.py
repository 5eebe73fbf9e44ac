"""Small cells for the CPU tests: the committed configurations and traffic
mixes at sizes a test run holds, run through the harness on the CPU (the
kernels' plain versions)."""

from __future__ import annotations

import json
import time

import torch

from portbench import harness

TINY_MODEL = {"hidden_size": 64, "intermediate_size": 128,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256}


def small_cell(name: str, **traffic) -> harness.Cell:
    """The committed cell ``name`` with its traffic mix's sizes replaced
    by ``traffic`` and, for a model, the model cut to ``TINY_MODEL``."""
    cell = harness.find_cell(harness.load_manifest(), name)
    config = json.loads(json.dumps(cell.config))
    if "model" in config:
        config["model"].update(TINY_MODEL)
    return harness.Cell(cell.name, cell.chips, config,
                        {**cell.traffic, **traffic}, cell.end_to_end,
                        cell.per_layer)


SMALL = {"summa.n16384.hybrid": {"n": 64},
         "summa.n32768.hybrid": {"n": 128},
         "train.qwen3-0.6b.2x4.s2048": {"seq_len": 32},
         "train.qwen3-0.6b.2x4.s4096": {"seq_len": 64}}


def run_small(name: str, seed: int = 3, seconds: float = 0.05):
    """One CPU run of the small version of ``name``."""
    torch.manual_seed(0)
    return harness.run_cell(small_cell(name, **SMALL[name]), seed=seed,
                            seconds=seconds, trace=False,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter())
