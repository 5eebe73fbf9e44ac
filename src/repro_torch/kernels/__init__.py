"""Kernels of the port: the Hopper panel-matmul kernel (``matmul``, CUDA C++
in ``csrc/matmul.cu``), its public wrapper (``ops``) and the plain oracles
(``ref``)."""
