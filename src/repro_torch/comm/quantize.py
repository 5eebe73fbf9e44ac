"""Quantized wire-format collective bodies (int8 / bf16 / packed int4).

The paper's C1 invariant attacks the *resident* bytes of a collective; this
module attacks the *wire* bytes on the slow bridge tier, where the
hierarchical decomposition concentrates all inter-node traffic.  Every body
keeps the on-node stages full precision — only the payload that crosses
``slow_axis`` is compressed — so the shared window a ``shared``-class result
hands out stays exact.

Layering: the registry schemes in ``repro_torch.comm.registry``
(``q8_hier``, ``qbf16_hier``, ``q4_shared``) bind these bodies; call sites
reach them only through ``Communicator(..., precision="lossy")``.

Every function takes the stacked layout: a leading rank axis ``(R, ...)``,
each rank's payload quantized on its own (the reference's per-device view).

Quantization model (per-block symmetric):

* each rank's payload is flattened and cut into ``block``-sized blocks, each
  with its own f32 scale ``amax / qmax`` — an outlier only collapses its own
  block;
* for *psum* payloads the wire schedule is picked by the bridge's rank
  count: small-world bridges (<= 3 ranks) fuse int8 codes + LOCAL scales
  into ONE u8 gather summed locally in f32; wider bridges share block scales
  with one ``pmax`` (every rank quantizes onto the same grid, so the int16
  wire sum is exact for <= 256 pods: 127 * 256 < 2**15);
* for *gather* payloads scales stay local and travel with the data;
* error feedback: the psum cores optionally take the previous residual
  (``err``) and return the new LOCAL quantization residual.

Bitcasts are ``Tensor.view(dtype)`` on contiguous tensors; ``torch.round``
rounds half to even, as ``jnp.round`` does.  A scale is ``amax`` times the
f32 reciprocal of ``qmax``: the reference divides by the constant ``qmax``,
and XLA compiles that division into this product, so codes and scales match
the compiled reference bit for bit.  ``stochastic=True`` takes a
``torch.Generator`` where the reference takes a jax key: the noise, and so
the codes, differ from JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm.primitives import _axes, axis_index, axis_size
from repro_torch.substrate import collectives as coll

DEFAULT_BLOCK = 256
Q8_MAX = 127.0
Q4_MAX = 7.0
_EPS = 1e-30


# ---------------------------------------------------------------------------
# Per-block quantize / dequantize cores
# ---------------------------------------------------------------------------

def _scale_of(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(amax, eps) / qmax`` as the compiled reference computes it."""
    # a fill, not a host-to-device copy, so the body can be captured in a
    # CUDA graph
    recip = torch.full((), 1.0 / qmax, dtype=torch.float32,
                       device=amax.device)
    return amax.clamp_min(_EPS) * recip


def _to_blocks(x: torch.Tensor, block: int
               ) -> tuple[torch.Tensor, int, int]:
    """Each rank's payload as f32 ``(R, n_blocks, block_eff)``, tail
    zero-padded.  Returns ``(blocks, size, block_eff)``; ``block_eff``
    shrinks to the per-rank size for payloads smaller than one block."""
    R = x.shape[0]
    flat = x.float().reshape(R, -1)
    size = flat.shape[1]
    block_eff = max(1, min(int(block), size))
    pad = (-size) % block_eff
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(R, -1, block_eff), size, block_eff


def _from_blocks(blocks: torch.Tensor, size: int, shape, dtype
                 ) -> torch.Tensor:
    R = blocks.shape[0]
    return blocks.reshape(R, -1)[:, :size].reshape(shape).to(dtype)


def block_quantize(x: torch.Tensor, *, block: int = DEFAULT_BLOCK,
                   qmax: float = Q8_MAX, shared_axes=(),
                   stochastic: bool = False,
                   generator: Optional[torch.Generator] = None):
    """Per-block symmetric quantization of each rank's payload.

    Returns ``(q, scale, meta)``: ``q`` int8 ``(R, n_blocks, block)``,
    ``scale`` f32 ``(R, n_blocks)``, ``meta = (size, block_eff)`` for
    :func:`block_dequantize`.  ``shared_axes`` max-reduces the block amax
    across ranks first (psum payloads must share one grid).
    """
    blocks, size, block_eff = _to_blocks(x, block)
    amax = blocks.abs().amax(dim=2)
    if shared_axes:
        amax = coll.pmax(amax, _axes(shared_axes))
    scale = _scale_of(amax, qmax)
    scaled = blocks / scale[..., None]
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        noise = torch.rand(scaled.shape, generator=generator,
                           device=scaled.device)
        q = torch.floor(scaled + noise)
    else:
        q = torch.round(scaled)
    q = q.clamp(-qmax, qmax).to(torch.int8)
    return q, scale, (size, block_eff)


def block_dequantize(q: torch.Tensor, scale: torch.Tensor, meta, shape,
                     dtype=torch.float32) -> torch.Tensor:
    size, _ = meta
    blocks = q.float() * scale[..., None]
    return _from_blocks(blocks, size, shape, dtype)


# ---------------------------------------------------------------------------
# Packed-int4 codec (two nibbles per uint8)
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in ``[-7, 7]`` two per byte along the last axis.

    Values are biased to ``[1, 15]`` (0 is never produced, so an all-zero
    byte can only mean padding).  The last axis extent must be even.
    """
    if q.shape[-1] % 2:
        raise ValueError(f"int4 pack needs an even extent, got "
                         f"{tuple(q.shape)}")
    b = (q.to(torch.int32) + 8).to(torch.uint8)
    lo, hi = b[..., 0::2], b[..., 1::2]
    return lo | (hi << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 ``(..., n)`` -> int8 ``(..., 2n)``."""
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        tuple(p.shape[:-1]) + (2 * p.shape[-1],))


def quantize_q4(w: torch.Tensor, *, group: int = 32):
    """Groupwise-K int4 weight quantization for the ``ag_matmul`` fast path.

    ``w`` is a ``(..., K, N)`` panel (any leading dims, e.g. the rank axis);
    each length-``group`` run of K rows in a column shares one f32 scale.
    Returns ``(packed, scales)``: ``packed`` uint8 ``(..., K // 2, N)``,
    byte *r* = row 2r | row 2r+1 << 4 with codes offset by 8, and
    ``scales`` f32 ``(..., K // group, N)``.  The Hopper kernel reads this
    layout.
    """
    *lead, k, n = w.shape
    if group % 2 or k % group:
        raise ValueError(f"K={k} must divide into even groups of {group}")
    lead = tuple(lead)
    g = w.float().reshape(lead + (k // group, group, n))
    amax = g.abs().amax(dim=-2)
    scales = _scale_of(amax, Q4_MAX)
    q = torch.round(g / scales[..., None, :]).clamp(-Q4_MAX, Q4_MAX)
    q = q.to(torch.int8).reshape(lead + (k, n))
    # pack along K: byte r holds rows (2r, 2r+1)
    b = (q.to(torch.int32) + 8).to(torch.uint8)
    packed = b[..., 0::2, :] | (b[..., 1::2, :] << 4)
    return packed, scales


def dequantize_q4(packed: torch.Tensor, scales: torch.Tensor, *,
                  group: int = 32, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_q4` -> ``(..., K, N)`` in ``dtype``."""
    *lead, k2, n = packed.shape
    lead = tuple(lead)
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    q = torch.stack([lo, hi], dim=-2).reshape(lead + (2 * k2, n))
    g = q.float().reshape(lead + (-1, group, n))
    return (g * scales[..., None, :]).reshape(lead + (2 * k2, n)).to(dtype)


# ---------------------------------------------------------------------------
# Quantized psum cores (gradient-bridge wire formats)
# ---------------------------------------------------------------------------

def _axes_count(axes) -> int:
    """Rank count of a (possibly empty) axis-name tuple."""
    return axis_size(axes) if axes else 1


def q8_psum_flat(x: torch.Tensor, axes, *, block: int = DEFAULT_BLOCK,
                 err=None, stochastic: bool = False,
                 generator: Optional[torch.Generator] = None):
    """int8-on-the-wire psum of ``x`` over ``axes``.

    The whole reduction is one bridge, with two wire schedules picked by
    the bridge's rank count ``p``:

    * ``p <= 3``: ONE tiled ``u8`` all-gather of a fused buffer — int8 codes
      followed by the rank's LOCAL per-block f32 scales — and every rank
      dequantizes ALL contributions (its own included, so totals are
      identical across ranks) and sums in f32;
    * ``p >= 4``: the per-block amax is shared via ``pmax`` so all ranks
      quantize onto the same grid, then the int8 codes are summed exactly
      in int16.

    With ``err`` the previous residual is folded in first and the new LOCAL
    residual is returned: ``(total, new_err)``; otherwise just ``total``.
    """
    axes = _axes(axes) if axes else ()
    x32 = x.float()
    if err is not None:
        x32 = x32 + torch.as_tensor(err, device=x.device).float()
    p = _axes_count(axes)
    R = x.shape[0]
    if p <= 3:
        q, scale, meta = block_quantize(x32, block=block, qmax=Q8_MAX,
                                        stochastic=stochastic,
                                        generator=generator)
        local = block_dequantize(q, scale, meta, x.shape, torch.float32)
        if axes and p > 1:
            nb = scale.shape[1]
            wire = torch.cat([q.reshape(R, -1).view(torch.uint8),
                              scale.view(torch.uint8).reshape(R, -1)], dim=1)
            length = wire.shape[1]
            # raw-collective: the fused u8 gather IS the scheme body
            g = coll.all_gather(wire, axes, axis=0).reshape(R, p, length)
            codes = g[:, :, :length - 4 * nb].contiguous().view(torch.int8)
            scales = g[:, :, length - 4 * nb:].contiguous().view(
                torch.float32)
            blocks = (codes.reshape((R, p) + tuple(q.shape[1:])).float()
                      * scales[..., None]).sum(dim=1)
            total = _from_blocks(blocks, meta[0], x.shape, torch.float32)
        else:
            total = local
        out = total.to(x.dtype)
        if err is None:
            return out
        return out, x32 - local
    q, scale, meta = block_quantize(x32, block=block, qmax=Q8_MAX,
                                    shared_axes=axes, stochastic=stochastic,
                                    generator=generator)
    local = block_dequantize(q, scale, meta, x.shape, torch.float32)
    # raw-collective: the int16 wire sum IS the scheme body (q8_hier)
    tot16 = coll.psum(q.to(torch.int16), axes)
    total = _from_blocks(tot16.float() * scale[..., None], meta[0], x.shape,
                         torch.float32)
    out = total.to(x.dtype)
    if err is None:
        return out
    return out, x32 - local


def qbf16_psum_flat(x: torch.Tensor, axes, *, err=None):
    """bf16-on-the-wire psum of ``x`` over ``axes`` (no scales).

    Each contribution is rounded to bf16, crosses the wire as a bitcast
    ``uint16`` gather, and the sum runs locally in f32 — one rounding per
    contribution.  Exact when ``x`` is already bf16.
    """
    axes = _axes(axes) if axes else ()
    x32 = x.float()
    if err is not None:
        x32 = x32 + torch.as_tensor(err, device=x.device).float()
    wire = x32.to(torch.bfloat16)
    if axes:
        codes = wire.view(torch.uint16)
        # raw-collective: the u16 bridge exchange IS the scheme body
        g = coll.all_gather(codes, axes, axis=0, tiled=False)
        tot = g.view(torch.bfloat16).float().sum(dim=1)
    else:
        tot = wire.float()
    out = tot.to(x.dtype)
    if err is None:
        return out
    return out, x32 - wire.float()


def _bridge_psum(x, fast_axis, slow_axis, axis, bridge_core, err):
    """Two-tier scaffold of the quantized psum bodies: full-precision
    ``psum_scatter`` over the fast tier, quantized ``bridge_core`` over the
    slow tier, full-precision ``all_gather`` back.  On a single-tier
    communicator (``slow_axis=None``) the whole reduction IS the bridge, so
    the core runs over ``fast_axis`` with no scatter."""
    fast = _axes(fast_axis)
    if slow_axis is None:
        return bridge_core(x, fast, err)
    shard = coll.psum_scatter(x, fast, scatter_dimension=axis)
    res = bridge_core(shard, _axes(slow_axis), err)
    total, new_err = res if err is not None else (res, None)
    out = coll.all_gather(total, fast, axis=axis)
    if err is None:
        return out
    return out, new_err


def q8_hier_psum(x: torch.Tensor, *, fast_axis, slow_axis=None,
                 axis: int = 0, block: int = DEFAULT_BLOCK, err=None):
    """Hier allreduce with an int8 bridge: on-node stages full precision."""
    def core(v, axes, e):
        return q8_psum_flat(v, axes, block=block, err=e)
    return _bridge_psum(x, fast_axis, slow_axis, axis, core, err)


def qbf16_hier_psum(x: torch.Tensor, *, fast_axis, slow_axis=None,
                    axis: int = 0, err=None):
    """Hier allreduce with a bf16 bridge: on-node stages full precision."""
    def core(v, axes, e):
        return qbf16_psum_flat(v, axes, err=e)
    return _bridge_psum(x, fast_axis, slow_axis, axis, core, err)


# ---------------------------------------------------------------------------
# Quantized allgather bodies
# ---------------------------------------------------------------------------

def _bridge_gather_blocks(q_flat, scale, slow_axis):
    """Gather int8 codes + f32 scales across the bridge (untiled)."""
    slow = _axes(slow_axis)
    # raw-collective: the compressed bridge exchange IS the scheme body
    gq = coll.all_gather(q_flat, slow, axis=0, tiled=False)
    gs = coll.all_gather(scale, slow, axis=0, tiled=False)
    return gq, gs


def _restore_own_region(out, node, slow_axis, axis):
    """Overwrite each rank's own-pod region with the exact full-precision
    copy — a pod never pays quantization error for its own contribution.
    The region starts at ``pod * size``, so it differs by pod."""
    start = axis_index(slow_axis) * node.shape[axis + 1]
    return coll.dynamic_update_slice_in_dim(out, node.to(out.dtype), start,
                                            axis=axis)


def _concat_pods(deq_flat, node_shape, axis, n_pods):
    """(R, n_pods, flat) -> per rank, the pod regions concatenated along
    local ``axis``."""
    R = deq_flat.shape[0]
    per_pod = deq_flat.reshape((R, n_pods) + tuple(node_shape))
    return torch.cat([per_pod[:, i] for i in range(n_pods)], dim=axis + 1)


def q8_hier_all_gather(x: torch.Tensor, *, fast_axis, slow_axis=None,
                       axis: int = 0, block: int = DEFAULT_BLOCK):
    """Hier allgather with an int8 bridge: the intra-pod gather stays full
    precision; the node region is per-block quantized with LOCAL scales and
    both codes and scales cross the bridge.  The caller's own pod region is
    restored exactly afterwards."""
    node = coll.all_gather(x, _axes(fast_axis), axis=axis)
    if slow_axis is None:
        return node
    R = x.shape[0]
    q, scale, meta = block_quantize(node, block=block, qmax=Q8_MAX)
    gq, gs = _bridge_gather_blocks(q.reshape(R, -1), scale, slow_axis)
    n_pods = gq.shape[1]
    blocks = gq.reshape((R, n_pods) + tuple(q.shape[1:])).float() \
        * gs[..., None]
    deq = blocks.reshape(R, n_pods, -1)[:, :, :meta[0]]
    out = _concat_pods(deq, node.shape[1:], axis, n_pods).to(x.dtype)
    return _restore_own_region(out, node, slow_axis, axis)


def qbf16_hier_all_gather(x: torch.Tensor, *, fast_axis, slow_axis=None,
                          axis: int = 0):
    """Hier allgather with a bf16 bridge (scale-free truncation), carried
    as bitcast u16 as in the reference."""
    node = coll.all_gather(x, _axes(fast_axis), axis=axis)
    if slow_axis is None:
        return node
    codes = node.to(torch.bfloat16).view(torch.uint16)
    # raw-collective: the compressed bridge exchange IS the scheme body
    gw = coll.all_gather(codes, _axes(slow_axis), axis=axis)
    out = gw.view(torch.bfloat16).float().to(x.dtype)
    return _restore_own_region(out, node, slow_axis, axis)


def q4_shared_all_gather(x: torch.Tensor, *, fast_axis, slow_axis=None,
                         axis: int = 0, block: int = DEFAULT_BLOCK):
    """Shared-window allgather with a packed-int4 bridge.

    Mirrors ``shared_all_gather``: the result lives ONCE per pod, sharded
    over ``fast_axis``; only the bridge exchange is compressed (two nibbles
    per byte + per-block f32 scales).  Identity on one pod.
    """
    if slow_axis is None:
        return x
    if x[0].numel() % 2:
        raise ValueError(f"q4 shared allgather needs an even payload size, "
                         f"got {tuple(x.shape[1:])}")
    R = x.shape[0]
    q, scale, meta = block_quantize(x, block=block, qmax=Q4_MAX)
    packed = pack_int4(q.reshape(R, -1))
    slow = _axes(slow_axis)
    # raw-collective: the packed-int4 bridge exchange IS the scheme body
    gp = coll.all_gather(packed, slow, axis=0, tiled=False)
    gs = coll.all_gather(scale, slow, axis=0, tiled=False)
    n_pods = gp.shape[1]
    codes = unpack_int4(gp).reshape((R, n_pods) + tuple(q.shape[1:])).float()
    deq = (codes * gs[..., None]).reshape(R, n_pods, -1)[:, :, :meta[0]]
    out = _concat_pods(deq, x.shape[1:], axis, n_pods).to(x.dtype)
    return _restore_own_region(out, x, slow_axis, axis)
