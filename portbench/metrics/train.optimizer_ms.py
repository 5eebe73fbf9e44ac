"""Device ms a step of the optimizer (``train::optimizer``, two a step): the
per-token mean, the grad norm and clip, and ``adamw_update_``.
Timed on the card by the span's CUDA event pair (``repro_torch.core.spans``);
None where the program has no such span."""

from portbench.metrics._spans import span_ms_per_unit


def read(r):
    return span_ms_per_unit(r, "train::optimizer", "steps")
