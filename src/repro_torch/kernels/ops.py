"""Public wrappers: layout glue around the Hopper kernels.

``matmul`` takes any (M, K) @ (K, N) — or a leading batch on both operands
— and returns (M, N) in ``a.dtype`` with fp32 accumulation.  The kernel
masks its own ragged edges, so no padding is needed.  CPU tensors take the
kernel's plain version; CUDA tensors take the kernel, or the wrapper raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.matmul import matmul_cuda, matmul_plain


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b)
    return matmul_cuda(a.contiguous(), b.contiguous())
