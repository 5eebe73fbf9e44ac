"""The dense model path on one device: configs -> ``ParallelCtx.single()``
-> ``build`` -> prefill / decode, with prefill attention through the
Hopper flash-attention kernel."""

from repro_torch.models.model_zoo import (Model, ParallelCtx, build,
                                          build_by_name, make_batch)

__all__ = ["Model", "ParallelCtx", "build", "build_by_name", "make_batch"]
