"""Device ms a multiply of SUMMA's accumulation (``summa::accumulate``, four a
multiply): each round's panel product added into the C blocks.
Timed on the card by the span's CUDA event pair (``repro_torch.core.spans``);
None where the program has no such span."""

from portbench.metrics._spans import span_ms_per_unit


def read(r):
    return span_ms_per_unit(r, "summa::accumulate", "multiplies")
