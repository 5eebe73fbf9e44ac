"""The flash forward kernel's share of its roofline over the window
(``csrc/flash_attention.cu``: ``flash_fwd`` and its ``v_nonfinite``
check).  The work is the causal attention forward of the global batch in
every layer (``work.flash_fwd_work``), once for each time the forward ran:
forward launches over backward launches, which counts the remat's
recompute and not how the rows are split over launches."""

from portbench.work import bound_s, flash_fwd_work

KERNELS = ("flash_fwd<", "v_nonfinite<")


def read(r):
    if r.trace is None:
        return None
    fwd, bwd = r.counters["flash_fwd_launches"], \
        r.counters["flash_bwd_launches"]
    t = r.trace.kernel_s(KERNELS)
    if not (fwd and bwd and t > 0):
        return None
    m, tr = r.config["model"], r.traffic
    one = bound_s(*flash_fwd_work(
        tr["global_batch"], tr["seq_len"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"]), r.config["peak"])
    layers_run = m["num_hidden_layers"] * r.counters["steps"]
    return 100.0 * one * layers_run * (fwd / bwd) / t
