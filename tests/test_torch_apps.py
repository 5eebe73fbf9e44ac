"""The port's paper applications (SUMMA, BPMF) end to end on the CPU, and
the port's independence from the JAX package.

The reference's examples run on 16 forced host devices in their own
process, so the applications are held to their own invariants here: every
SUMMA scheme gives A @ B (fp32, rtol 1e-5), BPMF's naive and hybrid
variants give identical predictions and the held-out RMSE falls below the
zero predictor's.
"""

import ast
import os
import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.apps import bpmf, summa

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("scheme", summa.SCHEMES)
def test_summa_every_scheme_is_a_at_b(scheme, use_kernel):
    g = torch.Generator().manual_seed(0)
    a = torch.randn((64, 64), generator=g)
    b = torch.randn((64, 64), generator=g)
    got = summa.summa(a, b, scheme=scheme, use_kernel=use_kernel, chunks=2)
    torch.testing.assert_close(got, a @ b, rtol=1e-5, atol=1e-5)


def test_summa_traffic_lines_show_the_hybrid_win():
    res = summa.tuning.resolve_for(summa.ROW_COMM, "psum", elems=256)
    assert "copy bytes/round=0 " not in summa.traffic_line("naive", 64,
                                                           res.scheme)
    for scheme in ("hybrid", "pipelined"):
        line = summa.traffic_line(scheme, 64, res.scheme)
        assert "intra-node copy bytes/round=0 " in line
        assert "panel copies/node=1" in line


def test_summa_rejects_bad_operands():
    with pytest.raises(ValueError, match="multiple of 16"):
        summa.summa(torch.ones(24, 24), torch.ones(24, 24), scheme="naive")
    with pytest.raises(ValueError, match="unknown scheme"):
        summa.summa(torch.ones(32, 32), torch.ones(32, 32), scheme="smp")


def test_bpmf_schemes_identical_and_rmse_falls():
    r_obs, mask, r, test = bpmf.synthetic(64, 64, 0.6, 0, "cpu")
    base = bpmf.rmse(torch.zeros_like(r), r, test)
    preds = {s: bpmf.bpmf(r_obs, mask, s, iters=10, seed=0)
             for s in bpmf.SCHEMES}
    assert torch.equal(preds["naive"], preds["hybrid"])
    assert torch.equal(preds["naive"], preds["auto"])
    assert bpmf.rmse(preds["naive"], r, test) < base


@pytest.mark.parametrize("app,argv", [
    (summa, ["--n", "32", "--device", "cpu", "--use-kernel"]),
    (bpmf, ["--users", "32", "--items", "32", "--iters", "2", "--device",
            "cpu"]),
])
def test_app_cli_runs_on_cpu(app, argv, capsys):
    app.main(argv)
    out = capsys.readouterr().out
    assert "scheme='auto' resolved" in out
    assert "naive" in out and "hybrid" in out


# ---------------------------------------------------------------------------
# independence from the JAX package
# ---------------------------------------------------------------------------

def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_and_runs_without_jax_or_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, torch\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.apps import summa\n"
        "a = torch.randn(32, 32); b = torch.randn(32, 32)\n"
        "c = summa.summa(a, b, scheme='hybrid', use_kernel=True)\n"
        "torch.testing.assert_close(c, a @ b, rtol=1e-5, atol=1e-5)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imported_names(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imported_names(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{f.relative_to(ROOT)} imports {name}"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA (or outside the repo) the script fails and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)],
                              cwd=script.parent, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
