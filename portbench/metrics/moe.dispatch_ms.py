"""Device ms a step of the MoE block's routing and data movement: the spans
``moe::route`` (router logits, top k, the sort into expert segments and
the tables), ``moe::dispatch`` (the gather into the segments) and
``moe::combine`` (the gather back, each token's rows added), forward and
its recompute; autograd runs their backward outside the spans.  Timed on
the card by the spans' CUDA event pairs; None where the program has no
such span."""

from portbench.metrics._spans import span_ms_per_unit

SPANS = ("moe::route", "moe::dispatch", "moe::combine")


def read(r):
    got = [span_ms_per_unit(r, name, "steps") for name in SPANS]
    if any(v is None for v in got):
        return None
    return sum(got)
