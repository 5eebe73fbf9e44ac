"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once; see ``harness``.
"""
