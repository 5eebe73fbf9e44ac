"""The flash backward kernel's share of its roofline over the window
(``csrc/flash_attention_bwd.cu``: ``prep`` and the ``flash_bwd_*``
kernels).  The work is the causal attention backward of the global batch
in every layer of every step (``work.flash_bwd_work``: the four gradient
products, not the recompute of S)."""

from portbench.work import bound_s, flash_bwd_work

KERNELS = ("::prep<", "flash_bwd_")


def read(r):
    if r.trace is None or not r.counters["flash_bwd_launches"]:
        return None
    t = r.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    m, tr = r.config["model"], r.traffic
    one = bound_s(*flash_bwd_work(
        tr["global_batch"], tr["seq_len"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"]), r.config["peak"])
    return 100.0 * one * m["num_hidden_layers"] * r.counters["steps"] / t
