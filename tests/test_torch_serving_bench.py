"""The ``serving`` bench family held against the reference.

``repro_torch.bench.serving``: the open-loop Poisson load model equal to
the reference's dict for the same step medians (and refusing a zero step);
the ``sync`` / ``recorded`` schemes registered with their fallbacks; the
family on 2x4 through ``run_suite`` with every link check — the warm-up's
and each timed rep's — passing and the report record's ``serving`` keys as
the reference's test reads them; and the link inventory the port records
from one decode step (the substrate's traffic record) equal to the
reference's jaxpr ``link_inventory`` of the same step on 2x4, fast and
slow bytes per chip, for both schemes.

The reference's registered ``sync`` inventory walks its decode with the
unit ``lax.scan`` at ``unroll=1``, where the jaxpr walk counts the scan body
— one unit's window reads — once (``_scan_copies``); a step runs every
unit's reads, which is what the port records.  So the port's ``sync`` is
held to the reference's inventory of the same body with the unit loop
unrolled (``unroll=n_units``, as the ``step_time`` family builds its
steps), which is also the reference's ``recorded`` inventory.  As in
``tests/test_torch_step_bench.py``, the reference's jaxpr walk needs
``jax.extend`` imported, so its inventories come from one subprocess
(``_REFERENCE``).
"""

import json
import os
import subprocess
import sys

import pytest

from repro.bench.serving import serving_metrics as jserving_metrics
from repro_torch.bench import report, suites
from repro_torch.bench import serving as sv
from repro_torch.comm import registry, tuning
from repro_torch.substrate import VirtualCluster

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

#: the reference's serving inventories on 2x4: as registered by its case
#: builder, and the sync body with the unit loop unrolled
_REFERENCE = """
import json
import jax
import jax.extend
from repro.bench import serving as sv
from repro.comm import registry
from repro.models import transformer
from repro.substrate import VirtualCluster

vc = VirtualCluster(pods=2, chips=4)
cases = list(sv.serving_cases(vc))
key = (2, 4, (4,), cases[0].elems)
inv = {c.scheme: list(registry.get_scheme(c.scheme)._inventory[key])
       for c in cases}
decode = transformer.Model.decode_fn


def unrolled(self, params, cache, token, pos, *, unroll=1):
    return decode(self, params, cache, token, pos, unroll=self.cfg.n_units)


transformer.Model.decode_fn = unrolled
list(sv.serving_cases(vc, schemes=("sync",)))
print(json.dumps({"registered": inv, "elems": cases[0].elems,
                  "n_units": sv.get_config(sv.SERVE_CONFIGS[0])
                  .reduced().n_units,
                  "sync_unrolled": list(
                      registry.get_scheme("sync")._inventory[key])}))
"""

VC2 = VirtualCluster(pods=2, chips=4, device="cpu")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _REFERENCE],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("step_us", [250.0, 1000.0, 2000.0, 12345.6])
def test_serving_metrics_equal_reference(step_us):
    got = sv.serving_metrics(step_us)
    assert got == jserving_metrics(step_us)
    assert got == sv.serving_metrics(step_us)        # pure
    slow = sv.serving_metrics(2 * step_us)
    assert slow["tokens_per_s"] < got["tokens_per_s"]
    assert slow["p99_token_ms"] > got["p99_token_ms"]
    assert got["p99_token_ms"] >= got["p50_token_ms"] > 0
    for fn in (sv.serving_metrics, jserving_metrics):
        with pytest.raises(ValueError):
            fn(0.0)


def test_serving_schemes_registered_with_fallbacks():
    assert {"sync", "recorded"} <= set(registry.scheme_names())
    for sch in registry.schemes_for("serving"):
        assert sch.result_class == "replicated"
        assert sch.result_node("serving", pods=2, chips=4, elems=8) == 32
    assert tuning.FALLBACK[None]["serving"] == "sync"
    assert tuning.FALLBACK["replicated"]["serving"] == "sync"
    assert (sv.SERVE_CONFIGS, sv.SERVE_SLOTS, sv.SERVE_SMAX) == (
        ("starcoder2-7b",), 4, 32)


def test_serving_family_end_to_end_on_2x4():
    cases = suites.build_cases(clusters=(VC2,), families=("serving",),
                               elems=(1024,), device="cpu")
    assert {c.scheme for c in cases} == {"sync", "recorded"}
    suite = suites.run_suite(cases, reps=2, log=None)
    for r in suite.cases:
        rec = report.case_record(r)
        assert rec["ok"], [c for c in rec["checks"] if not c["ok"]]
        names = {c["name"] for c in rec["checks"]}
        assert {"link/fast", "link/slow", "link/fast/timed",
                "link/slow/timed"} <= names
        assert rec["timing"]["mode"] == "eager"
        sv_rec = rec["serving"]
        assert sv_rec == sv.serving_metrics(rec["timing"]["median_us"])
        assert sv_rec["tokens_per_s"] > 0
        assert sv_rec["p99_token_ms"] >= sv_rec["p50_token_ms"] > 0
        assert rec["timing"]["p99_us"] >= rec["timing"]["p50_us"] > 0


def test_serving_link_inventory_equals_reference(reference):
    cases = suites.build_cases(clusters=(VC2,), families=("serving",),
                               device="cpu")
    elems = reference["elems"]
    assert {c.elems for c in cases} == {elems}
    key = (2, 4, (4,), elems)
    got = {c.scheme: list(registry.get_scheme(c.scheme)._inventory[key])
           for c in cases}
    reg = reference["registered"]
    assert got["recorded"] == reg["recorded"]
    assert got["sync"] == reference["sync_unrolled"] == reg["recorded"]
    # the registered sync walk counts one unit's reads of n_units
    n = reference["n_units"]
    unit = (reg["recorded"][0] - reg["sync"][0]) / (n - 1)
    assert unit > 0 and reg["sync"][1] == reg["recorded"][1]
    for c in cases:
        assert c.traffic.fast_bytes == got[c.scheme][0] * 8
        assert c.traffic.slow_bytes == got[c.scheme][1] * 8
