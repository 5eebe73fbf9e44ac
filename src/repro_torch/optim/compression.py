"""DEPRECATED gradient-compression free functions (one-release shims).

The reference's ``repro/optim/compression.py``.  The int8 bridge wire
format lives in the scheme registry: ``q8_hier`` (``repro_torch.comm.
quantize``) reached through ``Communicator.allreduce(..., precision=
"lossy")`` or ``ParallelCtx.reduce_grads(..., precision="lossy")``, with the
error-feedback residual riding the same call (``error_state=``).  The shims
below delegate to the registry's bodies and warn; nothing should gain new
call sites.  Quantization is per block (``quantize.DEFAULT_BLOCK``).

=====================================  ====================================
deprecated                             replacement
=====================================  ====================================
``int8_bridge_psum(g, axes)``          ``Communicator(fast_axis=axes)``
                                       ``.allreduce(g, precision="lossy")``
``make_error_feedback(params)``        ``reduce_grads(grads, metas,``
                                       ``precision="lossy",``
                                       ``error_state=state)``
=====================================  ====================================

The reference's ``stochastic`` rounding draws from a ``jax.random`` key;
here it draws from a ``torch.Generator`` (``generator=``).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.comm import quantize as qz
from repro_torch.core.tree import tree_map


def _warn(name: str, repl: str) -> None:
    warnings.warn(
        f"repro_torch.optim.compression.{name} is deprecated; use {repl} "
        f"(removal next release)", DeprecationWarning, stacklevel=3)


def int8_bridge_psum(g: torch.Tensor, axes, *, stochastic: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Quantized psum of the stacked ``g`` over ``axes`` (the bridge).
    DEPRECATED shim."""
    _warn("int8_bridge_psum",
          "Communicator.allreduce(..., precision='lossy')")
    return qz.q8_psum_flat(g, axes, stochastic=stochastic,
                           generator=generator)


def make_error_feedback(params_like):
    """Returns ``(init, compress_leaf)``: ``init()`` the f32 zero residuals
    shaped like ``params_like``, ``compress_leaf(g, err, axes) -> (g_red,
    new_err)`` the quantized bridge psum with the LOCAL residual carried.
    DEPRECATED shim over ``reduce_grads(..., precision="lossy",
    error_state=...)``."""
    _warn("make_error_feedback",
          "reduce_grads(..., precision='lossy', error_state=...)")

    def init():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params_like)

    def compress_leaf(g, err, axes):
        # the residual of the LOCAL quantization only (the psum total holds
        # the other pods' contributions; feeding it back would diverge)
        return qz.q8_psum_flat(g, axes, err=err)

    return init, compress_leaf
