"""Plain reference of a distributed C = A @ B: one f32 product.

``product`` is ``torch.matmul`` in float32 with TF32 off, which is what the
configuration states.  ``precision="tf32"`` is the control: each operand
rounded to TF32 (10 mantissa bits, as the tensor cores read an f32 operand
in TF32 mode) before the f32 product, on any device.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, precision: str = "fp32"
            ) -> torch.Tensor:
    """a @ b in float32 (TF32 off), or with TF32 operands (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(a, b)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error over the largest magnitude of ``want``."""
    return float((got - want).abs().max() / want.abs().max())
