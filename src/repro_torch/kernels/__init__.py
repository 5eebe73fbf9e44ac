"""Kernels of the port: the Hopper panel-matmul kernel (``matmul``, CUDA C++
in ``csrc/matmul.cu``), the dequant-fused int4 matmul (``quant``, CUDA C++ in
``csrc/q4_matmul.cu``), the one builder both go through (``_cuda``), their
public wrappers (``ops``) and the plain oracles (``ref``)."""
