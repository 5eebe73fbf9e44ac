"""xLSTM's depthwise causal convolution (the reference's
``repro/models/xlstm.py``).

Only ``causal_conv1d`` is ported: the reference's ``rglru`` block imports it
from there.  The mLSTM / sLSTM blocks of the rest of ``xlstm.py`` wait for
ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import torch


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (..., B, T, C), w (..., C, K) (leading dims
    alike: stacked ranks)."""
    K = w.shape[-1]

    def tap(k):                                   # (..., 1, 1, C)
        return w[..., k].unsqueeze(-2).unsqueeze(-2)

    out = x * tap(-1)
    for j in range(1, K):
        shifted = torch.nn.functional.pad(x, (0, 0, j, 0))[..., :-j, :]
        out = out + shifted * tap(K - 1 - j)
    return out
