"""Device ms a step of the model's forward and backward
(``train::forward_backward``, one a memory domain: the loss and
``torch.autograd.grad``).
Timed on the card by the span's CUDA event pair (``repro_torch.core.spans``);
None where the program has no such span."""

from portbench.metrics._spans import span_ms_per_unit


def read(r):
    return span_ms_per_unit(r, "train::forward_backward", "steps")
