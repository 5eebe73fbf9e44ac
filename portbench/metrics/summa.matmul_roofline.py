"""The panel kernel's share of its roofline: the least time the card
could take for the window's panel products (2 n^3 FLOP a multiply against
the TF32 peak, or each round's A, B and C panels moved once against HBM,
whichever is longer) over the device time of the panel-kernel launches
(``panel_matmul``, ``csrc/matmul.cu``)."""

from portbench.work import bound_s, summa_flops, summa_panel_bytes

KERNEL = ("panel_matmul",)


def read(r):
    if r.trace is None:
        return None
    t = r.trace.kernel_s(KERNEL)
    if t <= 0:
        return None
    n, g = r.traffic["n"], r.config["grid"]
    bound = bound_s(summa_flops(n),
                    summa_panel_bytes(n, g["nodes"], g["cores"]),
                    r.config["peak"])
    return 100.0 * bound * r.counters["multiplies"] / t
