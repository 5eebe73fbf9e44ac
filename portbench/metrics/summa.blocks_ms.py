"""Device ms a multiply of SUMMA's layout copies (``summa::blocks``, two a
multiply): A and B into blocks and the zero C, then C out of its blocks.
Timed on the card by the span's CUDA event pair (``repro_torch.core.spans``);
None where the program has no such span."""

from portbench.metrics._spans import span_ms_per_unit


def read(r):
    return span_ms_per_unit(r, "summa::blocks", "multiplies")
