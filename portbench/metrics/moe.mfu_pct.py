"""The whole step's share of the card's peak for a sparse-expert model: the
model FLOP of the window's steps with the active parameters
(``work_moe.moe_step_flops``: 6 x q/k/v/o, the router, the top k experts'
three matrices and the unembedding x tokens, plus 3 x the causal attention
forward; no recomputation) over the window's time, against the
configuration's peak (TF32, 495 TFLOP/s)."""

from portbench.work_moe import moe_step_flops


def read(r):
    t = r.traffic
    flops = moe_step_flops(r.config["model"], t["global_batch"],
                           t["seq_len"]) * r.window.units
    return 100.0 * flops / (r.window.seconds
                            * r.config["peak"]["flops_per_s"])
