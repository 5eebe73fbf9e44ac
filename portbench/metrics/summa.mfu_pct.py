"""The whole multiply's share of the card's peak: 2 n^3 FLOP a multiply
over the window's time a multiply, against the configuration's peak
(TF32, 495 TFLOP/s)."""

from portbench.work import summa_flops


def read(r):
    per_multiply = r.window.seconds / r.window.units
    return 100.0 * summa_flops(r.traffic["n"]) / (
        per_multiply * r.config["peak"]["flops_per_s"])
