"""Device ms a step of the gradient bridge (``train::bridge``): the world
allreduces of the loss and token partials and ``ParallelCtx.reduce_grads``
(or the step graph's record and run).
Timed on the card by the span's CUDA event pair (``repro_torch.core.spans``);
None where the program has no such span."""

from portbench.metrics._spans import span_ms_per_unit


def read(r):
    return span_ms_per_unit(r, "train::bridge", "steps")
