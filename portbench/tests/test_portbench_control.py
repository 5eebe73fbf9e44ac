"""The control and the planted faults at a size a test run holds: the
reference in TF32, or with a fault, put in the program's place, is judged
not correct by the committed limits (``python3 -m portbench.control``
judges them at the cells' own sizes on the card)."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from portbench.tests.cells import SMALL, small_cell


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_and_faults_fail_a_limit(name):
    cell = small_cell(name, **SMALL[name])
    got = control.readings(cell, 5, torch.device("cpu"))
    faults = getattr(harness.driver_for(cell.config), "FAULTS", ())
    assert set(got) == {"control", *faults}
    for stand_in, checks in got.items():
        assert {c.name for c in checks} == set(cell.config["limits"])
        assert not all(c.ok for c in checks), (stand_in, checks)
