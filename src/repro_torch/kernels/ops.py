"""Public wrappers: layout glue around the Hopper kernels.

``matmul`` takes any (M, K) @ (K, N) — or a leading batch on both operands
— and returns (M, N) in ``a.dtype`` with fp32 accumulation.  ``q4_matmul``
takes ``a`` (M, K) with the packed-int4 weight (K/2, N) and its group
scales (K/group, N) — or a leading batch on all three — and returns
``a @ dequantize_q4(...)`` the same way.  The kernels mask their own ragged
edges, so no padding is needed.  CPU tensors take a kernel's plain version;
CUDA tensors take the kernel, or the wrapper raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.matmul import matmul_cuda, matmul_plain
from repro_torch.kernels.quant import q4_matmul_cuda, q4_matmul_plain


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return matmul_plain(a, b)
    return matmul_cuda(a.contiguous(), b.contiguous())


def q4_matmul(a: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
              group: int = 32) -> torch.Tensor:
    if _on_cpu(a, packed, scales):
        return q4_matmul_plain(a, packed, scales, group)
    return q4_matmul_cuda(a.contiguous(), packed.contiguous(),
                          scales.contiguous(), group)
