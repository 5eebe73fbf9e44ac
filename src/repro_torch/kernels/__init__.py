"""Kernels of the port: the Hopper panel-matmul kernel (``matmul``, CUDA C++
in ``csrc/matmul.cu``), the dequant-fused int4 matmul (``quant``, CUDA C++ in
``csrc/q4_matmul.cu``), the flash-attention kernel (``flash_attention``,
CUDA C++ in ``csrc/flash_attention.cu``), the linear-recurrence scan
(``lru_scan``, CUDA C++ in ``csrc/lru_scan.cu``), the one builder all four
go through (``_cuda``), their public wrappers (``ops``) and the plain
oracles and CPU emulations (``ref``)."""
