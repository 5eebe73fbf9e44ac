"""Device idle ms a step inside the program: the traced window's gaps
between device activities whose middle lies inside a host ``train::`` span
(the step and the batch's layout).  The program's share of
``train.idle_pct``; the rest falls between steps, in the benchmark's loop.
None where the program has no such span."""

from portbench.metrics._spans import idle_ms_per_unit


def read(r):
    return idle_ms_per_unit(r, "train::", "steps")
