"""The grouped expert kernel's share of its roofline over the window
(``csrc/matmul.cu``'s ``grouped_matmul``).  The work is every layer's
expert products over the global batch's routed rows (tokens x top k,
``work_moe.experts_pass_work``), once for each forward the step ran (the
remat's recompute: NN launches over NT launches) and once each for the
backward's dX (NT) and dW (TN), against the TF32 peak; None where the
program counts no grouped launches."""

from portbench.work import bound_s
from portbench.work_moe import experts_pass_work


def read(r):
    if r.trace is None:
        return None
    nn, nt, tn = (r.counters.get(f"grouped_{x}_launches")
                  for x in ("nn", "nt", "tn"))
    t = r.trace.kernel_s(("grouped_matmul<",))
    if not (nn and nt and tn and t > 0):
        return None
    m, tr = r.config["model"], r.traffic
    one = bound_s(*experts_pass_work(m, tr["global_batch"], tr["seq_len"]),
                  r.config["peak"])
    passes = nn / nt + 1.0 + tn / nt
    layers_run = m["num_hidden_layers"] * r.counters["steps"]
    return 100.0 * one * layers_run * passes / t
