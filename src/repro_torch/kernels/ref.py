"""Plain PyTorch oracles for every kernel (the allclose ground truth), and
CPU emulations of the kernels' arithmetic — 3xTF32 with the non-finite
rule, the q4 unpack, the chunked scan and its reverse — as test aids,
never on a main path."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Tq, hd); k, v: (B, KV, Tkv, hd).  Exact softmax attention
    with GQA head mapping, fp32 throughout."""
    B, H, Tq, hd = q.shape
    KV, Tkv = k.shape[1], k.shape[2]
    group = H // KV
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) / math.sqrt(hd)
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tkv, device=q.device)
    mask = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask[None, None], s, torch.full((), -1e30,
                                                    device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def lru_scan_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t along dim 1, fp32 carry."""
    af, xf = a.float(), x.float()
    h = torch.zeros_like(xf[:, 0])
    out = torch.empty_like(xf)
    for t in range(xf.shape[1]):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h
    return out.to(x.dtype)


def lru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                     gh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``lru_scan_ref`` given its output ``h`` and the
    output's cotangent ``gh``: the reverse scan g_t = gh_t + a_{t+1}
    g_{t+1} (g past T is 0), then (dx, da) = (g, g_t h_{t-1}) with h_{-1}
    = 0; fp32 carry, both in a's dtype."""
    af, gf = a.float(), gh.float()
    g = torch.zeros_like(gf[:, 0])
    dx = torch.empty_like(gf)
    for t in reversed(range(gf.shape[1])):
        if t + 1 < gf.shape[1]:
            g = af[:, t + 1] * g + gf[:, t]
        else:
            g = gf[:, t]
        dx[:, t] = g
    da = dx * _shifted(h.float())
    return dx.to(a.dtype), da.to(a.dtype)


def _shifted(h: torch.Tensor) -> torch.Tensor:
    """h_{t-1} along dim 1, h_{-1} = 0."""
    return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` as the kernels carry it on the tensor cores, two f32 tensors
    ``(big, small)``: big = tf32(x), rounded to nearest (ties away) on the
    10-bit mantissa through an int32 view, the bits of cvt.rna.tf32.f32;
    small = x - big as the tensor core reads it, truncated to TF32."""
    xf = x.float()
    big = ((xf.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    small = ((xf - big).view(torch.int32) & -0x2000).view(torch.float32)
    return big, small


def _tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a_small b_big + a_big b_small + a_big b_big in f32 (each product of
    two TF32 values exact in f32, the sums in f32)."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _recompute_tiles(out: torch.Tensor, exact, rows: int,
                     cols: int) -> torch.Tensor:
    """The kernels' non-finite rule: each (rows, cols) tile of the last two
    dims of ``out`` that holds a non-finite value is taken from
    ``exact()`` (the IEEE fp32 arithmetic on the same operands)."""
    bad = ~torch.isfinite(out)
    if not bad.any():
        return out
    full, out = exact(), out.clone()
    M, N = out.shape[-2:]
    for i in range(0, M, rows):
        for j in range(0, N, cols):
            tile = (..., slice(i, i + rows), slice(j, j + cols))
            hit = bad[tile].flatten(-2).any(-1)[..., None, None]
            out[tile] = torch.where(hit, full[tile], out[tile])
    return out


def matmul_tf32x3_emulated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels compute it: 3xTF32 (``_tf32x3``), then the
    non-finite rule on each 128 x 128 output tile (a tile with a
    non-finite value is recomputed in fp32, as ``a @ b`` gives it).  Output
    in ``a.dtype``."""
    out = _recompute_tiles(_tf32x3(a, b), lambda: a.float() @ b.float(),
                           128, 128)
    return out.to(a.dtype)


def q4_matmul_tf32x3_emulated(a: torch.Tensor, packed: torch.Tensor,
                              scales: torch.Tensor,
                              group: int = 32) -> torch.Tensor:
    """``csrc/q4_matmul.cu``'s arithmetic: the weight unpacked as
    (code - 8) * scale (one f32 multiply, ``dequantize_q4``'s value), then
    ``a`` times it as 3xTF32 with the non-finite rule
    (``matmul_tf32x3_emulated``; a bf16 ``a`` splits with small = 0)."""
    from repro_torch.comm.quantize import dequantize_q4
    return matmul_tf32x3_emulated(a, dequantize_q4(packed, scales,
                                                   group=group))


def lru_scan_chunked_emulated(a: torch.Tensor, x: torch.Tensor,
                              chunk: int = 128) -> torch.Tensor:
    """``csrc/lru_scan.cu``'s arithmetic: each T-chunk's aggregate from a
    zero carry, (prod a, h at its end); the carries passed forward chunk by
    chunk (carry_j = A_j carry_{j-1} + X_j, chunk 0's = X_0); each chunk
    rescanned from the carry before it.  fp32 throughout, output in x's
    dtype."""
    B, T, C = x.shape
    n = -(-T // chunk)
    pad = n * chunk - T               # identity steps: a = 1, x = 0
    ap = torch.cat([a.float(), torch.ones(B, pad, C)], 1).reshape(
        B, n, chunk, C)
    xp = torch.cat([x.float(), torch.zeros(B, pad, C)], 1).reshape(
        B, n, chunk, C)
    agg_a, agg_x = torch.ones(B, n, C), torch.zeros(B, n, C)
    for t in range(chunk):
        agg_x = ap[:, :, t] * agg_x + xp[:, :, t]
        agg_a = agg_a * ap[:, :, t]
    carry, carries = torch.zeros(B, C), []
    for j in range(n):
        carries.append(carry)
        carry = agg_a[:, j] * carry + agg_x[:, j] if j else agg_x[:, 0]
    h, out = torch.stack(carries, 1), torch.empty(B, n, chunk, C)
    for t in range(chunk):
        h = ap[:, :, t] * h + xp[:, :, t]
        out[:, :, t] = h
    return out.reshape(B, n * chunk, C)[:, :T].to(x.dtype)


def lru_scan_bwd_chunked_emulated(a: torch.Tensor, h: torch.Tensor,
                                  gh: torch.Tensor, chunk: int = 128
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/lru_scan_bwd.cu``'s arithmetic: the reverse scan's
    coefficients a_{t+1} (0 at the last step); each T-chunk's aggregate
    from a zero carry at its end, (prod a_{t+1}, g at its first row); the
    carries passed backward chunk by chunk (carry_j = A_j carry_{j+1} +
    X_j, the last chunk's = X); each chunk rescanned backwards from the
    carry after it; da = g h_{t-1}.  fp32 throughout, both in a's
    dtype."""
    B, T, C = gh.shape
    n = -(-T // chunk)
    pad = n * chunk - T               # identity steps: coefficient 1, gh 0
    f = dict(dtype=torch.float32, device=gh.device)
    coef = torch.cat([a.float()[:, 1:], torch.zeros(B, 1, C, **f),
                      torch.ones(B, pad, C, **f)], 1).reshape(B, n, chunk, C)
    gp = torch.cat([gh.float(), torch.zeros(B, pad, C, **f)], 1).reshape(
        B, n, chunk, C)
    agg_a, agg_x = torch.ones(B, n, C, **f), torch.zeros(B, n, C, **f)
    for t in reversed(range(chunk)):
        agg_x = coef[:, :, t] * agg_x + gp[:, :, t]
        agg_a = agg_a * coef[:, :, t]
    carry, carries = torch.zeros(B, C, **f), [None] * n
    for j in reversed(range(n)):
        carries[j] = carry
        carry = agg_a[:, j] * carry + agg_x[:, j] if j < n - 1 \
            else agg_x[:, j]
    g, out = torch.stack(carries, 1), torch.empty(B, n, chunk, C, **f)
    for t in reversed(range(chunk)):
        g = coef[:, :, t] * g + gp[:, :, t]
        out[:, :, t] = g
    dx = out.reshape(B, n * chunk, C)[:, :T]
    da = dx * _shifted(h.float())
    return dx.to(a.dtype), da.to(a.dtype)


def attention_tf32x3_emulated(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None,
                              q_offset: int = 0) -> torch.Tensor:
    """The flash kernel's plain version (q (B, H, Tq, hd), k and v (B, KV,
    Tkv, hd), pre-scaled q, -1e30 masks, fp32 softmax) with its two
    products, q.k and p.v, as emulated 3xTF32; then the kernel's
    non-finite rule: each 64-row q tile of a head with a non-finite output,
    and every tile if V holds a non-finite element, is recomputed with
    fp32 products."""
    B, H, Tq, hd = q.shape
    KV, Tkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Tq, hd) * (1.0 / math.sqrt(hd))
    kt, vf = k.float()[:, :, None].transpose(-1, -2), v.float()[:, :, None]
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tkv, device=q.device)
    mask = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window

    def attend(product):
        s = torch.where(mask, product(qf, kt),
                        torch.full((), -1e30, device=q.device))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return product(p, vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)

    def exact():
        return attend(torch.matmul)

    o = exact() if not torch.isfinite(v).all() else _recompute_tiles(
        attend(_tf32x3), exact, 64, hd)
    return o.reshape(B, H, Tq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# The flash backward kernel's algorithm (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

def _visible(Tq: int, Tkv: int, causal: bool, window: Optional[int],
             q_offset: int, device) -> torch.Tensor:
    """(Tq, Tkv) bool: the keys each row sees under the forward's mask."""
    qpos = q_offset + torch.arange(Tq, device=device)
    kpos = torch.arange(Tkv, device=device)
    vis = torch.ones((Tq, Tkv), dtype=torch.bool, device=device)
    if causal:
        vis &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        vis &= (qpos[:, None] - kpos[None, :]) < window
    return vis


def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """The forward kernel's ``lse`` output, (B, H, Tq) fp32: the log-sum-exp
    of each row's visible scaled scores (-inf for a row with none)."""
    B, H, Tq, hd = q.shape
    KV, Tkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Tq, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgqd,bktd->bkgqt", qf, k.float())
    vis = _visible(Tq, Tkv, causal, window, q_offset, q.device)
    s = torch.where(vis, s, torch.full((), -math.inf, device=q.device))
    return torch.logsumexp(s, dim=-1).reshape(B, H, Tq)


def _tf32x1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The one big.big TF32 product of bf16 operands (a widened bf16 value
    is its own big; an f32 intermediate is rounded to TF32)."""
    return split_tf32(a)[0] @ split_tf32(b)[0]


def flash_attention_bwd_tf32x3_emulated(q, k, v, o, do, lse, *,
                                        causal: bool = True,
                                        window: Optional[int] = None,
                                        q_offset: int = 0
                                        ) -> tuple[torch.Tensor, ...]:
    """``csrc/flash_attention_bwd.cu``'s arithmetic on the CPU (bhtd
    layout): D = rowsum(do o o); S = scale q.k and dP = do.v as 3xTF32
    products (``_tf32x3``; the one TF32 product for bf16); P = exp(S - lse)
    on the visible keys (0 elsewhere and on rows with no visible key), dS =
    P (dP - D); then, at the kernel's tile size (16 streamed rows a step
    at hd >= 128, 32 below), each key tile's dS k added into the fp32 dq
    sum, and for every q head of the group in order each q tile's P^T do
    and dS^T q added into the fp32 dv and dk sums — each tile's product as
    3xTF32, summed from zero, folded in with one add; dq and dk times
    scale; then each row with no visible key adds do / Tkv to every key's
    dv.  The exact path (``_bwd_exact``)
    is taken instead when q, k, v or do holds a non-finite or large
    (|x| > 1e15) element, or D or a visible row's lse is not finite, and
    also when this fast path's fp32 gradients are not finite (the kernel's
    recompute rule).  Returns (dq, dk, dv) in the operands' dtype."""
    vis = _visible(q.shape[2], k.shape[2], causal, window, q_offset,
                   q.device)
    D = (do.float() * o.float()).sum(-1)
    large = [x.float() for x in (q, k, v, do)]
    bad = any((~torch.isfinite(x) | (x.abs() > 1e15)).any() for x in large)
    bad = bad or not torch.isfinite(D).all() \
        or not torch.isfinite(lse[..., vis.any(dim=1)]).all()
    if not bad:
        grads = _bwd_tf32x3_fast(q, k, v, do, lse, D, vis)
        if all(torch.isfinite(x).all() for x in grads):
            return tuple(x.to(y.dtype) for x, y in zip(grads, (q, k, v)))
    return _bwd_exact(q, k, v, do, vis)


def _bwd_tf32x3_fast(q, k, v, do, lse, D, vis):
    """The fast path of ``flash_attention_bwd_tf32x3_emulated``: fp32
    (dq, dk, dv), not yet rounded to the operands' dtype."""
    B, H, Tq, hd = q.shape
    KV, Tkv = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    prod = _tf32x3 if q.dtype == torch.float32 else _tf32x1
    bs = 16 if hd >= 128 else 32       # the kernel's Fast<HD>::BS
    qf = q.float().reshape(B, KV, G, Tq, hd)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    g = do.float().reshape(B, KV, G, Tq, hd)
    s = prod(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(vis, torch.exp(s - lse.float().reshape(B, KV, G, Tq, 1)),
                    torch.zeros(()))
    dp = prod(g, vf.transpose(-1, -2))
    ds = p * (dp - D.reshape(B, KV, G, Tq, 1))
    dq = torch.zeros(B, KV, G, Tq, hd)
    for j0 in range(0, Tkv, bs):
        dq = dq + prod(ds[..., j0:j0 + bs], kf[..., j0:j0 + bs, :])
    dk = torch.zeros(B, KV, Tkv, hd)
    dv = torch.zeros(B, KV, Tkv, hd)
    for h in range(G):
        for i0 in range(0, Tq, bs):
            i1 = i0 + bs
            dv = dv + prod(p[:, :, h, i0:i1].transpose(-1, -2),
                           g[:, :, h, i0:i1])
            dk = dk + prod(ds[:, :, h, i0:i1].transpose(-1, -2),
                           qf[:, :, h, i0:i1])
    dv = dv + g[..., ~vis.any(dim=1), :].sum(dim=(2, 3))[:, :, None] / Tkv
    return (dq.reshape(B, H, Tq, hd) * scale, dk * scale, dv)


def bwd_overflow_inputs(generator: torch.Generator, device=None):
    """Finite (q, k, v, do), all within the backward's 1e15 bound, whose dk
    overflows fp32: one q row with a 1e15 element in a column that every
    key zeroes (the scores stay normal), v and that row's do near 1e14, so
    dS near 1e27 times 1e15 passes the fp32 range; 3xTF32's cross terms
    make NaN of some of those infinities.  Shapes (1, 4 | 2, 64, 32),
    causal: the case for the backward kernel's recompute rule."""
    q, k, v, do = (torch.randn((1, n, 64, 32), generator=generator,
                               device=device) for n in (4, 2, 2, 4))
    k[..., 3] = 0.0
    q[0, 1, 40, 3] = 1e15
    v *= 1e14
    do[0, 1, 40] *= 1e14
    return q, k, v, do


def _bwd_exact(q, k, v, do, vis):
    """The exact path: the plain version's forward and the autograd formulas
    of each of its steps, written out in fp32 — the NaN-propagating max and
    its ties, exp(s - max), the sum clamped at 1e-30 (whose gradient is 0
    where the sum is below it or NaN), the division's two gradients, the
    max's gradient divided over the ties and times the tie mask, the mask's
    zero."""
    B, H, Tq, hd = q.shape
    KV, Tkv = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, KV, G, Tq, hd) * scale
    kf, vf = k.float(), v.float()
    g = do.float().reshape(B, KV, G, Tq, hd)
    s = torch.where(vis, torch.einsum("bkgqd,bktd->bkgqt", qf, kf),
                    torch.full((), -1e30))
    nan = torch.isnan(s)
    mx = torch.where(nan.any(dim=-1, keepdim=True), torch.full((), math.nan),
                     s.masked_fill(nan, -math.inf).amax(-1, True))
    tie = (s == mx).float()
    ties = tie.sum(-1, keepdim=True)
    e = torch.exp(s - mx)
    total = e.sum(-1, keepdim=True)
    ou = torch.einsum("bkgqt,bktd->bkgqd", e, vf)
    den = torch.where(torch.isnan(total), total, total.clamp_min(1e-30))
    dou = g / den
    dden = (-g * ((ou / den) / den)).sum(-1, keepdim=True)
    dsum = torch.where(total >= 1e-30, dden, torch.zeros(()))
    de = dsum + torch.einsum("bkgqd,bktd->bkgqt", dou, vf)
    dsm = de * e
    dmx = (-dsm).sum(-1, keepdim=True)
    ds = torch.where(vis, dsm + (dmx / ties) * tie, torch.zeros(()))
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qf)
    dv = torch.einsum("bkgqt,bkgqd->bktd", e, dou)
    return (dq.reshape(B, H, Tq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
