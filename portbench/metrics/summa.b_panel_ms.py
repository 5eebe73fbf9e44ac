"""Device ms a multiply of SUMMA's B-panel phase (``summa::b_panel``, four a
multiply): the B column select and the bridge psum over the nodes.
Timed on the card by the span's CUDA event pair (``repro_torch.core.spans``);
None where the program has no such span."""

from portbench.metrics._spans import span_ms_per_unit


def read(r):
    return span_ms_per_unit(r, "summa::b_panel", "multiplies")
