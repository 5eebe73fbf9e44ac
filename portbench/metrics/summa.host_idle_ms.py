"""Device idle ms a multiply inside the program: the traced window's gaps
between device activities whose middle lies inside a host ``summa::``
span.  The program's share of ``summa.idle_pct``; the rest falls between
multiplies, in the benchmark's loop.  None where the program has no such
span."""

from portbench.metrics._spans import idle_ms_per_unit


def read(r):
    return idle_ms_per_unit(r, "summa::", "multiplies")
