"""The routing's skew: the mean over the window's dropless MoE forwards of
the largest expert segment over the mean segment (1 for an even split),
from the program's device tally (``models.moe.tally``); None where the
program keeps no such tally."""


def read(r):
    n = r.counters.get("moe_forwards")
    if not n:
        return None
    return r.counters["moe_load_max_ratio_sum"] / n
