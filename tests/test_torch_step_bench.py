"""The ``step_time`` bench family held against the reference.

``repro_torch.runtime.steps.make_step_bench`` against the reference's on
the reduced ``starcoder2-7b`` at 2x4, from the reference's own arguments
(its ``make_args()`` laid out on the port's cluster): loss rtol 2e-4,
gnorm 5e-3, the parameter checksum rtol 2e-4, for each scheme.  The
port's ``prefetch`` and ``stepgraph`` give outputs ``torch.equal`` to
``eager``.  The link inventory the port records from one step
(``bench.step_time.link_inventory``: the substrate's traffic record,
window reads as the all-gathers they stand for) equals the reference's
``link_inventory`` read off the step's jaxpr, fast and slow bytes per chip,
for every (config, scheme) at 2x4; the step graph sends fewer slow-tier
messages with the slow bytes conserved; and the family runs through the
bench on the CPU with every link check, the timed reps' included, passing.

The reference's jaxpr walk reads ``jax.extend.core`` only when
``jax.extend`` is already imported (it falls back to ``jax.core``, which no
longer has ``ClosedJaxpr`` in this jax).  Importing ``jax.extend`` here
would change how every other test in the same process runs the
reference, so the reference's inventories and its family's cases are
computed once in a subprocess that imports it (``_REFERENCE``).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.runtime.steps import make_step_bench as jmake_step_bench
from repro.substrate import VirtualCluster as JVC
from repro_torch.bench import step_time as st
from repro_torch.bench import suites
from repro_torch.configs import get_config
from repro_torch.runtime.steps import make_step_bench
from repro_torch.substrate import VirtualCluster

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

#: the reference's link inventory per (config, scheme) at 2x4 and its
#: step_time cases' rows, printed as one JSON object
_REFERENCE = """
import json, sys
import jax
import jax.extend
from repro.bench import step_time as jst
from repro.bench import suites as jsuites
from repro.configs import get_config
from repro.runtime.steps import make_step_bench
from repro.substrate import VirtualCluster

schemes = json.loads(sys.argv[1])
vc = VirtualCluster(pods=2, chips=4)
inv = []
for cfg_name in jst.STEP_CONFIGS:
    cfg = get_config(cfg_name).reduced()
    for scheme, opts in schemes.items():
        body, ins, outs, make_args, _ = make_step_bench(
            cfg, vc, opts=tuple(opts), unroll=cfg.n_units)
        fn = vc.smap(body, ins, outs)
        fast, slow = jst.link_inventory(
            fn, tuple(jax.ShapeDtypeStruct(a.shape, a.dtype)
                      for a in make_args()), vc)
        inv.append([cfg_name, scheme, fast, slow])
cases = jsuites.build_cases(clusters=(vc,), families=("step_time",))
rows = [[c.family, c.scheme, c.topology, c.elems, c.traffic.fast_bytes,
         c.traffic.slow_bytes, c.traffic.result_bytes_per_node]
        for c in cases]
print(json.dumps({"inventory": inv, "rows": rows}))
"""

SCHEMES = {"eager": (), "prefetch": ("prefetch",),
           "stepgraph": ("stepgraph",)}


@pytest.fixture(scope="module")
def reference():
    """The reference's inventories {(config, scheme): (fast, slow)} and its
    step_time case rows at 2x4, from one subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(SCHEMES)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return ({(c, s): (f, sl) for c, s, f, sl in got["inventory"]},
            [tuple(r) for r in got["rows"]])


def _vcs():
    return JVC(pods=2, chips=4), VirtualCluster(pods=2, chips=4,
                                                device="cpu")


def _ref(cfg_name, opts):
    jvc, _ = _vcs()
    jcfg = jget(cfg_name).reduced()
    body, ins, outs, make_args, elems = jmake_step_bench(
        jcfg, jvc, opts=opts, unroll=jcfg.n_units)
    return jvc.smap(body, ins, outs), make_args(), elems


def _port(cfg_name, opts):
    _, vc = _vcs()
    return make_step_bench(get_config(cfg_name).reduced(), vc, opts=opts)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_step_bench_matches_reference(scheme):
    fn, jargs, jelems = _ref("starcoder2-7b", SCHEMES[scheme])
    want = [float(x) for x in jax.jit(fn)(*jargs)]
    body, in_specs, out_specs, _, elems = _port("starcoder2-7b",
                                                SCHEMES[scheme])
    assert elems == jelems and len(in_specs) == len(jargs)
    assert out_specs == ((), (), ())
    _, vc = _vcs()
    args = tuple(vc.layout(torch.from_numpy(np.array(a)), s)
                 for a, s in zip(jargs, in_specs))
    with vc.bind():
        loss, gnorm, csum = (float(t[0]) for t in body(*args))
    np.testing.assert_allclose(loss, want[0], rtol=2e-4)
    np.testing.assert_allclose(gnorm, want[1], rtol=5e-3)
    np.testing.assert_allclose(csum, want[2], rtol=2e-4)


def test_prefetch_and_stepgraph_are_bit_identical_to_eager():
    _, vc = _vcs()
    out = {}
    for name, opts in SCHEMES.items():
        body, _, _, make_args, _ = _port("starcoder2-7b", opts)
        args = make_args()
        with vc.bind():
            out[name] = body(*args)
            again = body(*args)          # pure: the same arguments again
        for a, b in zip(out[name], again):
            assert torch.equal(a, b)
    for name in ("prefetch", "stepgraph"):
        for a, b in zip(out[name], out["eager"]):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("cfg_name", st.STEP_CONFIGS)
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_link_inventory_equals_reference(cfg_name, scheme, reference):
    want = reference[0][cfg_name, scheme]
    _, vc = _vcs()
    body, _, _, make_args, _ = _port(cfg_name, SCHEMES[scheme])
    assert st.link_inventory(body, make_args(), vc) == want


def test_stepgraph_sends_fewer_slow_messages_with_bytes_conserved():
    from repro_torch.analysis.traffic import RING
    _, vc = _vcs()
    slow = {}
    for name in ("eager", "stepgraph"):
        body, _, _, make_args, _ = _port("starcoder2-7b", SCHEMES[name])
        ent = st.link_entries(body, make_args(), vc)
        assert all(e.group > 1 for e in ent)
        slow[name] = [e for e in ent if e.tier == "slow"]
    assert len(slow["stepgraph"]) < len(slow["eager"])
    tot = {k: sum(RING[e.op](e.out_bytes, e.group) for e in v)
           for k, v in slow.items()}
    assert tot["stepgraph"] == pytest.approx(tot["eager"])


def test_step_time_family_runs_and_validates(reference):
    """The family through the bench: the same cases as the reference's
    (family, scheme, topology, elems, traffic), each timed eagerly, every
    link check passing — the case's warm-up and each timed rep against the
    inventory recorded when the case was built."""
    _, vc = _vcs()
    cases = suites.build_cases(clusters=(vc,), families=("step_time",),
                               device="cpu")
    assert [(c.family, c.scheme, c.topology, c.elems,
             c.traffic.fast_bytes, c.traffic.slow_bytes,
             c.traffic.result_bytes_per_node)
            for c in cases] == reference[1]
    res = suites.run_suite(cases, reps=2)
    for r in res.cases:
        names = {c.name for c in r.checks}
        assert {"link/fast", "link/slow", "link/fast/timed",
                "link/slow/timed"} <= names
        assert all(c.ok for c in r.checks)
        assert r.timing.mode == "eager" and r.timing.reps == 2
