"""PyTorch port of the hybrid MPI+MPI collectives for one NVIDIA GPU.

The JAX package ``repro`` is the reference; this package imports neither it
nor ``jax``.  Layout mirrors the reference: ``substrate`` (the stacked
two-tier cluster), ``core`` (topology, closed forms, sync), ``comm``
(primitives, window, registry, tuning, pipeline, Communicator), ``kernels``
(the Hopper kernels and the plain oracles), ``analysis`` (the traffic and
memory evidence, the profiler), ``apps`` (SUMMA and BPMF, paper §5.2),
and the dense-model serving path: ``configs``, ``models``, ``data``,
``serving`` and ``launch``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
