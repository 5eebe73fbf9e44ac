"""Share of the traced SUMMA window in which no kernel or copy ran on the
card: 100 x (1 - busy / wall)."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.window.seconds)
