"""Device ms a multiply of SUMMA's A-panel phase (``summa::a_panel``, four a
multiply): the A row select and the row broadcast, in the hybrid scheme
the node's shared-window reduce-scatter and its read.
Timed on the card by the span's CUDA event pair (``repro_torch.core.spans``);
None where the program has no such span."""

from portbench.metrics._spans import span_ms_per_unit


def read(r):
    return span_ms_per_unit(r, "summa::a_panel", "multiplies")
