"""The port's API-surface guard (``python -m
repro_torch.tools.check_api_surface``): clean on the package as it stands,
and a planted bypass of each of its four rules is flagged — a raw tier
kwarg, a raw substrate collective (called or imported by name, with the
``# raw-collective:`` pragma as the way out), a deprecated
``int8_bridge_psum(`` call and a bare ``Communicator(`` in the rebuild
paths — while ``VirtualCluster(...)`` and the blessed classmethods pass.
"""

import subprocess
import sys

import pytest

from repro_torch.tools import check_api_surface as guard


def _plant(root, rel, text):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_the_port_is_clean():
    assert guard.violations() == []
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.tools.check_api_surface"],
                         capture_output=True, text=True)
    assert out.returncode == 0 and "OK" in out.stdout


@pytest.mark.parametrize("rel,text,check,line", [
    ("analysis/rogue.py",
     "from repro_torch.comm import primitives as p\n"
     "def f(x, comm):\n"
     "    return p.shared_read(x, fast_axis=comm.fast_axis)\n",
     guard.kwarg_violations, 3),
    ("models/rogue.py",
     "from repro_torch.substrate import collectives as coll\n"
     "def f(x):\n"
     "    return coll.psum(x, 'data')\n",
     guard.raw_violations, 3),
    ("bench/rogue.py",
     "from repro_torch.substrate.collectives import recording, all_gather\n",
     guard.raw_violations, 1),
    ("runtime/rogue.py",
     "from repro_torch.optim.compression import int8_bridge_psum\n"
     "y = int8_bridge_psum(g, ('pod',))\n",
     guard.deprecated_violations, 2),
    ("launch/rogue.py",
     "from repro_torch.comm import Communicator\n"
     "world = Communicator(fast_axis='data', slow_axis='pod')\n",
     guard.ctor_violations, 2),
])
def test_each_rule_flags_a_planted_bypass(tmp_path, rel, text, check, line):
    _plant(tmp_path, rel, text)
    hits = check(tmp_path)
    assert len(hits) == 1 and hits[0].startswith(f"{rel}:{line}:")
    assert guard.main([str(tmp_path)]) == 1


def test_allowed_spellings_pass(tmp_path):
    _plant(tmp_path, "models/fine.py",
           "from repro_torch.substrate import VirtualCluster\n"
           "vc = VirtualCluster(pods=2, chips=4, fast_axis=('dp', 'tp'),\n"
           "                    fast_shape=(2, 2), slow_axis='pod')\n"
           "tp = Communicator(fast_axis='model')\n"
           "fast_axis: str = 'data'   # a field, not a call kwarg\n"
           "def f(x):\n"
           "    # raw-collective: the tp fast path\n"
           "    return coll.psum(x, 'tp')\n"
           "# the old path called coll.psum(x, 'data') directly\n")
    _plant(tmp_path, "runtime/fine.py",
           "world = Communicator.from_cluster(vc)\n"
           "node = world.split_type_shared()\n")
    for rel in ("comm/impl.py", "substrate/impl.py", "kernels/impl.py"):
        _plant(tmp_path, rel, "y = coll.all_gather(x, 'data')\n"
               "z = coll.ppermute(x, 'data', perm)\n")
    _plant(tmp_path, "optim/shim.py", "y = int8_bridge_psum(g, ('pod',))\n")
    assert guard.violations(tmp_path) == []
    assert guard.main([str(tmp_path)]) == 0
