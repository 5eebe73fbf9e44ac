"""The whole step's share of the card's peak: the model FLOP of the
window's steps (``work.train_step_flops``: 6 x the matrix parameters x
tokens plus 3 x the causal attention forward; no recomputation) over the
window's time, against the configuration's peak (TF32, 495 TFLOP/s)."""

from portbench.work import train_step_flops


def read(r):
    t = r.traffic
    flops = train_step_flops(r.config["model"], t["global_batch"],
                             t["seq_len"]) * r.window.units
    return 100.0 * flops / (r.window.seconds
                            * r.config["peak"]["flops_per_s"])
