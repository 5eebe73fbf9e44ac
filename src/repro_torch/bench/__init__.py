"""In-process collective benchmark (``python -m repro_torch.bench``).

* ``runner``   — the timer: exactly one warm-up call, then each (case,
  candidate) body captured once in a ``torch.cuda.CUDAGraph`` and its
  replays timed with CUDA events (eager launches would otherwise set every
  small-message time); a body that cannot be captured is timed eagerly and
  says so; median with IQR / p50 / p99;
* ``suites``   — the allgather, broadcast, psum, reduce_scatter,
  allgatherv and alltoall families over ``substrate.default_matrix()`` x
  message sizes, the scheme list per family pulled from the
  ``repro_torch.comm`` registry and every case dispatched through a
  ``Communicator``;
* ``validate`` — every measured config's recorded link bytes
  (``substrate.collectives.recording`` priced by
  ``analysis.traffic.link_bytes``) against the scheme's ``links()`` closed
  form, its resident result bytes per node against ``result_node()``, and
  the paper's C1 ratio across schemes; any mismatch fails the run;
* ``report``   — the schema-versioned JSON report and the
  ``name,us_per_call,derived`` CSV rows;
* ``gates``    — the standard-library gates over reports, tables and
  schedule reports (``python -m repro_torch.bench.gates``).

On one card every rank of a topology is stacked on the device, so the
timings rank device copies on that card, not NVLink links.
"""

SCHEMA_VERSION = "repro_torch.bench/v1"

__all__ = ["SCHEMA_VERSION"]
