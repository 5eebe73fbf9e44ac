"""Kernels of the port: the Hopper panel-matmul kernel (``matmul``, CUDA C++
in ``csrc/matmul.cu``), the dequant-fused int4 matmul (``quant``, CUDA C++ in
``csrc/q4_matmul.cu``), the flash-attention kernel (``flash_attention``,
CUDA C++ in ``csrc/flash_attention.cu``), the linear-recurrence scan
(``lru_scan``, CUDA C++ in ``csrc/lru_scan.cu``), the backward kernels of
flash attention and the scan, the MoE block's row movements
(``moe_gather``, CUDA C++ in ``csrc/moe_gather.cu``), the one builder
they all go through (``_cuda``), their public wrappers (``ops``) and the
plain oracles and CPU emulations (``ref``)."""
