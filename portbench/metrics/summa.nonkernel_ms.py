"""Device-busy ms a multiply outside the panel kernel: the broadcasts, the
window's reduce-scatter and reads, the accumulation and the layout copies
(and the benchmark's own copy of the sampled rows, a few hundred KiB)."""

KERNEL = ("panel_matmul",)


def read(r):
    if r.trace is None or not r.counters["multiplies"]:
        return None
    return 1e3 * (r.trace.busy_s - r.trace.kernel_s(KERNEL)) \
        / r.counters["multiplies"]
