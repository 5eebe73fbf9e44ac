"""The command line: no fallback to the CPU, and (on a card) one short run
whose last line is the result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness

CELL = "summa.n16384.hybrid"


def _run(*args, cwd=harness.ROOT, timeout=900):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "portbench", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_without_a_card_it_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is not reachable")
    p = _run("--workload", CELL, "--seed", "2147483650", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA" in p.stderr


def test_an_unknown_cell_fails_and_prints_no_result():
    p = _run("--workload", "no.such.cell", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_one_short_run_on_the_card(card):
    p = _run("--workload", CELL, "--seed", "4000000007", "--seconds", "2",
             "--trace", "0")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"setup_s", "summa_ms", "peak_mem_gib"}
    assert list(out)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check rel_err")
