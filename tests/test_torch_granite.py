"""Granite-3.0 MoE as published, on the CPU: the port's dropless MoE block
and a tiny granite train step (2 layers, d 64, 4 experts top 2, hier on
2x4) held against the benchmark's plain reference
(``portbench/reference/granite_moe.py``) on seeded weights, with every
multiplier away from 1; dropless routing equal to the capacity path with
room for every token (on 2x4 and 4x2), and refused with a tp axis; decode
continuing prefill, dropless and with the softmax over the published
vocabulary; the grouped product's plain version and its autograd
Function; the MoE row movements (``kernels.moe_gather``'s plain versions,
``ops.MoeDispatch`` / ``MoeCombine``) bit for bit the padded-gather and
k-term composition they replaced, with ``gradcheck``; the flash plain path
at a given scale equal to ``scaled_dot_product_attention``; and the
registered config left as the reference's."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.configs.base import MoESpec
from repro_torch.core import tree as T
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import moe_gather as kmoe
from repro_torch.kernels import ops
from repro_torch.models import meta, moe
from repro_torch.models.moe import drops
from repro_torch.models.parallel import ParallelCtx
from repro_torch.runtime.steps import make_cluster_train_step
from repro_torch.substrate import VirtualCluster

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = {"hidden_size": 64, "intermediate_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 250}


def _bench_config() -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "granite-moe-3b-a800m.json").read_text())
    cfg["model"].update(TINY)
    return cfg


def _granite(capacity_factor=None, **kw):
    """The reduced registered granite with the published multipliers."""
    base = get_config("granite-moe-3b-a800m").reduced()
    return dataclasses.replace(
        base, moe=dataclasses.replace(base.moe,
                                      capacity_factor=capacity_factor),
        tie_embeddings=True, embed_scale=12.0, residual_scale=0.22,
        attn_scale=1 / 64, logit_scale=6.0, **kw)


def test_dropless_block_matches_the_reference_block():
    """One dropless block on 3 x 40 tokens (a domain's rows routed as one
    set): x + 0.22 MoE(rms(x)) as the reference computes it expert by
    expert, and the gradients of x and of every leaf."""
    from portbench.reference import granite_moe as ref
    cfg = _granite()
    defs = meta.moe_defs(cfg, 1, False)
    g = torch.Generator().manual_seed(5)
    p = {k: torch.randn(m.shape, generator=g) * (0.3 if k == "ln" else 0.2)
         for k, m in defs.items()}
    x = torch.randn((3, 40, cfg.d_model), generator=g)
    ctx = dataclasses.replace(ParallelCtx.single(), fold=3)

    def grads(fn):
        xs = x.clone().requires_grad_(True)
        ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y = fn(xs, ps)
        return [y] + list(torch.autograd.grad(
            (y * torch.cos(y)).sum(), [xs] + [ps[k] for k in sorted(ps)]))

    port = grads(lambda xs, ps: moe.moe_block(xs[None], ps, defs, ctx,
                                              cfg)[0])
    m = {"num_local_experts": 4, "num_experts_per_tok": 2}
    rt = ref._Routing(0, None, 0.0)

    def reference(xs, ps):
        u = ref.rms_norm(xs.reshape(-1, cfg.d_model), ps["ln"], cfg.norm_eps)
        y = ref._moe(u, ps, m, torch.matmul, rt, (0, 0), None)
        return xs + 0.22 * y.reshape(xs.shape)

    want = grads(reference)
    for a, b in zip(port, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("label", ["2x4", "4x2"])
def test_dropless_equals_a_capacity_of_every_token(label):
    """``capacity_factor=None`` (the grouped path) against the capacity
    path at ``E`` (a capacity of N k + 1: nothing can drop): the same loss
    and parameters after a step."""
    vc = VirtualCluster.from_label(label, device="cpu")
    toks = np.random.default_rng(1).integers(0, 256, size=(8, 17))
    out = []
    for cf in (None, 4.0):
        b = make_cluster_train_step(_granite(cf), vc, mode="hier",
                                    global_batch=8)
        state = b.init_layout_state(0)
        state, mt = b.step(state, b.layout_batch({"tokens": toks}))
        out.append((mt["loss"], T.leaves(state["params"])))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_dropless_with_a_tp_axis_raises():
    """Dropless routing has no expert-parallel form: on ``2x(2x2)`` (a tp
    axis) the step refuses it instead of sizing a buffer for every
    token."""
    vc = VirtualCluster.from_label("2x(2x2)", device="cpu")
    toks = np.random.default_rng(1).integers(0, 256, size=(8, 17))
    b = make_cluster_train_step(_granite(), vc, mode="hier", global_batch=8)
    state = b.init_layout_state(0)
    with pytest.raises(ValueError, match="dropless MoE routing"):
        b.step(state, b.layout_batch({"tokens": toks}))


def test_tiny_train_step_matches_the_reference():
    """The benchmark's configuration file cut to ``TINY`` (its four
    multipliers, tied embedding at 12, dropless top 2 of 4): two hier steps
    on 2x4 against ``reference.granite_moe.train`` from the same
    parameters and batches, by the benchmark's own gaps; every dropless
    forward's skew tallied."""
    from portbench.drivers import train_moe
    cfg = _bench_config()
    traffic = {"global_batch": 8, "seq_len": 24, "zipf_a": 1.3,
               "check_steps": 2, "window_batches": 1}
    before = moe.tally.read()
    sess = train_moe.setup(cfg, traffic, 11, torch.device("cpu"))
    after = moe.tally.read()
    # 2 steps x 2 domains x 2 layers, each forward and its recompute
    assert after["forwards"] - before["forwards"] == 16
    # each forward's largest segment is at least the mean
    assert after["load_max_ratio_sum"] - before["load_max_ratio_sum"] >= 16
    pc = train_moe.port_config(cfg)
    assert (pc.input_scale, kflash.softmax_scale(16, pc.attn_scale),
            pc.residual_scale, pc.logit_scale, pc.moe.capacity_factor,
            pc.softmax_vocab) == (12.0, 0.015625, 0.22, 6.0, None, 250)
    sess.release()
    checks = sess.check()
    assert {c.name for c in checks} == set(cfg["limits"])
    assert all(c.ok for c in checks), checks


def test_decode_continues_prefill_with_the_multipliers():
    """Serving the published granite (reduced, a vocabulary of 250 padded
    to 256): a prefill of 16 tokens then 16 decode steps give the last
    logits of a 32-token prefill, the input, residual, attention and logit
    multipliers on both paths, the MoE blocks dropless (the grouped path,
    as in training) and the pad rows' logits -inf."""
    from repro_torch.models import build
    from repro_torch.models.model_zoo import make_batch
    cfg = _granite(vocab=250, mask_vocab_pad=True)
    m = build(cfg, ParallelCtx.single(), device="cpu")
    params = m.init_params(0)
    batch = make_batch(cfg, B=2, T=32, device="cpu")
    with moe.routes() as rec:
        _, want = m.prefill_fn(params, batch, 32)
    assert drops(rec) == (2 * 32 * 2 * cfg.n_layers,) * 2
    cache, got = m.prefill_fn(params, {"tokens": batch["tokens"][:, :17]},
                              32)
    before = moe.tally.forwards
    for i in range(16, 32):
        cache, got = m.decode_fn(params, cache,
                                 batch["tokens"][:, i:i + 1], i)
    assert moe.tally.forwards - before == 16 * cfg.n_layers
    assert want.shape[-1] == 256
    assert torch.isneginf(want[..., 250:]).all()
    assert torch.isfinite(want[..., :250]).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    plain = dataclasses.replace(cfg, embed_scale=None, residual_scale=1.0,
                                attn_scale=None, logit_scale=1.0)
    _, other = build(plain, ParallelCtx.single(), device="cpu").prefill_fn(
        params, batch, 32)
    assert not torch.allclose(other, want, rtol=1e-2)


def test_segment_tables_sort_stably_into_expert_segments():
    idx = torch.tensor([[2, 0], [0, 3], [2, 3], [3, 0]])
    order, counts, offsets = moe.segment_tables(idx, 5)
    assert order.tolist() == [1, 2, 7, 0, 4, 3, 5, 6]
    assert counts.tolist() == [3, 0, 2, 3, 0]
    assert offsets.tolist() == [0, 3, 3, 5, 8, 8]
    assert offsets.dtype == torch.int32


def test_grouped_plain_version_and_its_autograd_function():
    """The grouped product's plain version segment by segment in its three
    layouts, and ``ops.GroupedMatmul`` (called directly: the layouts' plain
    versions) against the autograd of the segments' products; an empty
    segment's dW is zero."""
    g = torch.Generator().manual_seed(7)
    counts = [0, 5, 1, 0, 9]
    off = torch.tensor([0] + counts).cumsum(0).int()
    x = torch.randn((15, 6), generator=g, dtype=torch.float64)
    w = torch.randn((5, 6, 4), generator=g, dtype=torch.float64)
    o = off.tolist()
    want = torch.cat([x[o[s]:o[s + 1]] @ w[s] for s in range(5)])
    assert torch.equal(kmatmul.grouped_matmul_plain(x, w, off), want)
    torch.testing.assert_close(kmatmul.grouped_matmul_plain(
        x, w.transpose(1, 2).contiguous(), off, "nt"), want)
    dy = torch.randn((15, 4), generator=g, dtype=torch.float64)
    tn = kmatmul.grouped_matmul_plain(x, dy, off, "tn")
    assert tn.shape == (5, 6, 4) and not tn[0].any() and not tn[3].any()
    torch.testing.assert_close(tn[4], x[6:].T @ dy[6:])
    xa, wa = (t.clone().requires_grad_(True) for t in (x, w))
    (ops.GroupedMatmul.apply(xa, wa, off) * dy).sum().backward()
    xb, wb = (t.clone().requires_grad_(True) for t in (x, w))
    (torch.cat([xb[o[s]:o[s + 1]] @ wb[s] for s in range(5)]) * dy) \
        .sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad)
    torch.testing.assert_close(wa.grad, wb.grad)
    with pytest.raises(ValueError, match="rise from 0"):
        kmatmul.grouped_matmul_plain(x, w, off.flip(0))


# the MoE block's row movements as the port composed them before the
# ``moe_gather`` entries (``kmoe.gather_rows``: a gather from a zero-padded
# copy; ``kmoe.ordered_sum``: the k terms added one by one), with the
# backward autograd built around them


class _DispatchThen(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, table, inv):
        ctx_.save_for_backward(inv)
        return kmoe.gather_rows(x, table)

    @staticmethod
    def backward(ctx_, g):
        (inv,) = ctx_.saved_tensors
        return kmoe.ordered_sum(kmoe.gather_rows(g, inv)), None, None


class _RowGatherThen(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, buf, inv, back):
        ctx_.save_for_backward(back)
        return kmoe.gather_rows(buf, inv)

    @staticmethod
    def backward(ctx_, g):
        (back,) = ctx_.saved_tensors
        b, N, k, d = g.shape
        return kmoe.gather_rows(g.reshape(b, N * k, d), back), None, None


def _row_by_row(x, table, src, g, inv, back, dy, d_buf):
    """The four movements one row at a time, from their definitions: buf,
    y, d_src, d_g and dx (a sentinel index reads nothing, an empty cell
    gets zeros; the k terms added in ascending j)."""
    b, N, k = inv.shape
    S, d = src.shape[1:]
    buf = torch.zeros((b, table.shape[1], d), dtype=x.dtype)
    y, dx = (torch.zeros((b, N, d), dtype=x.dtype) for _ in range(2))
    d_src = torch.zeros((b, S, d), dtype=x.dtype)
    d_g = torch.zeros((b, N, k), dtype=x.dtype)
    for e in range(b):
        for r, t in enumerate(table[e].tolist()):
            if t < N:
                buf[e, r] = x[e, t]
        for r, s in enumerate(back[e].tolist()):
            if s < N * k:
                d_src[e, r] = g[e, s // k, s % k] * dy[e, s // k]
        for t in range(N):
            rows = [src[e, r] if r < S else torch.zeros(d, dtype=x.dtype)
                    for r in inv[e, t].tolist()]
            grads = [d_buf[e, r] if r < S else torch.zeros(d, dtype=x.dtype)
                     for r in inv[e, t].tolist()]
            y[e, t], dx[e, t] = rows[0] * g[e, t, 0], grads[0]
            for j in range(1, k):
                y[e, t] = y[e, t] + rows[j] * g[e, t, j]
                dx[e, t] = dx[e, t] + grads[j]
            d_g[e, t] = torch.stack([(dy[e, t] * r_).sum() for r_ in rows])
    return buf, y, d_src, d_g, dx


def _gather_case(b, k, sentinels, seed, dtype=torch.float32):
    """b batch entries of N tokens routed top k over E experts: the
    capacity tables (C small, one expert of no token: dropped slots and
    empty cells) or the dropless ones (every cell one slot), with x, the
    gates and a gradient of the output, in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    N, E, d = 6, 4, 5
    idx = torch.stack([torch.stack([torch.randperm(E, generator=g)[:k]
                                    if k <= E else
                                    torch.randint(E, (k,), generator=g)
                                    for _ in range(N)]) for _ in range(b)])
    if sentinels:
        table, slot = moe.dispatch_tables(idx, e0=0, n_local=E + 1,
                                          capacity=max(1, N * k // (2 * E)))
    else:
        slot = torch.stack([moe.segment_tables(i, E)[0] for i in idx])
        slot = slot.reshape(b, 1, N * k)
        table = slot // k
    inv, perm, back = moe.combine_tables(slot, N, k)
    S = slot.shape[-2] * slot.shape[-1]
    assert bool((inv == S).any() and (back == N * k).any()) == sentinels
    x = torch.randn((b, N, d), generator=g, dtype=dtype)
    out = torch.randn(tuple(table.shape) + (d,), generator=g, dtype=dtype)
    gate = torch.softmax(torch.randn((b, N, k), generator=g, dtype=dtype),
                         -1)
    dy = torch.randn((b, N, d), generator=g, dtype=dtype)
    return dict(table=table, inv=inv, perm=perm, back=back, x=x, out=out,
                gate=gate, dy=dy, S=S, N=N, d=d)


@pytest.mark.parametrize("sentinels", [False, True],
                         ids=["dropless", "capacity"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_moe_gather_equals_the_composition_it_replaces(k, b, sentinels):
    """``moe.dispatch`` / ``moe.combine`` (through ``ops.MoeDispatch`` /
    ``ops.MoeCombine``, whose backward is written by hand) against the
    padded-gather and k-term composition they replace with autograd's
    backward, f32 bit for bit: the buffers, the combined rows, the tokens'
    gradient, the buffers' gradient and the gates' gradient; the four
    ``moe_gather`` plain versions against the movements done row by row
    (bit for bit; the gates' gradient, a sum in another order, within
    1e-6); a batch of b tables, with sentinels (dropped slots, empty cells)
    or none; then ``gradcheck`` of both Functions in float64."""
    c = _gather_case(b, k, sentinels, seed=10 * k + b)
    table, inv, perm, back = c["table"], c["inv"], c["perm"], c["back"]
    S, N, d = c["S"], c["N"], c["d"]

    def run(new):
        x = c["x"].clone().requires_grad_(True)
        out = c["out"].clone().requires_grad_(True)
        gate = c["gate"].clone().requires_grad_(True)
        if new:
            buf = moe.dispatch(x, table, inv)
            y = moe.combine(out, gate, inv, perm, back)
        else:
            buf = _DispatchThen.apply(x, table.reshape(b, S), inv)
            rows = _RowGatherThen.apply(out.reshape(b, S, d), inv,
                                        back.reshape(b, S))
            y = kmoe.ordered_sum(rows, torch.gather(gate, -1, perm))
        grads = torch.autograd.grad(
            (buf.reshape(b, S, d), y), (x, out, gate),
            (c["out"].reshape(b, S, d), c["dy"]))
        return (buf.reshape(b, S, d), y) + grads

    got, want = run(True), run(False)
    for name, a, w in zip(("buf", "y", "dx", "d_out", "d_gate"), got, want):
        assert a.shape == w.shape and torch.equal(a, w), name

    g = torch.gather(c["gate"], -1, perm)
    src, tab = c["out"].reshape(b, S, d), table.reshape(b, S)
    back_ = back.reshape(b, S)
    d_src, d_g = kmoe.combine_bwd_plain(c["dy"], g, inv, src, back_)
    assert torch.equal(d_src, want[3].reshape(b, S, d))
    assert torch.equal(d_g.new_zeros(c["gate"].shape).scatter_(-1, perm, d_g),
                       want[4])
    plain = (kmoe.dispatch_plain(c["x"], tab, inv),
             kmoe.combine_plain(src, g, inv), d_src, d_g,
             kmoe.dispatch_bwd_plain(src, inv))
    slow = _row_by_row(c["x"], tab, src, g, inv, back_, c["dy"], src)
    for name, a, w in zip(("buf", "y", "d_src", "d_g", "dx"), plain, slow):
        if name == "d_g":
            torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(a, w), name

    c64 = _gather_case(b, k, sentinels, seed=10 * k + b,
                       dtype=torch.float64)
    x, src = (t.requires_grad_(True) for t in
              (c64["x"], c64["out"].reshape(b, S, d)))
    g = torch.gather(c64["gate"], -1, perm).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x_: ops.MoeDispatch.apply(x_, tab, inv), (x,))
    assert torch.autograd.gradcheck(
        lambda s_, g_: ops.MoeCombine.apply(s_, g_, inv, back_), (src, g))


def test_moe_gather_plain_versions_check_their_operands():
    """The contract the kernels share: int64 indices, one float dtype, the
    shapes of one batch."""
    x = torch.zeros((2, 4, 3))
    inv = torch.zeros((2, 4, 2), dtype=torch.long)
    with pytest.raises(TypeError, match="int64"):
        kmoe.dispatch_plain(x, torch.zeros((2, 5), dtype=torch.int32), inv)
    with pytest.raises(ValueError, match="want"):
        kmoe.dispatch_plain(x, torch.zeros((3, 5), dtype=torch.long), inv)
    with pytest.raises(ValueError, match="want"):
        kmoe.dispatch_bwd_plain(x, inv[:, :, 0])
    with pytest.raises(TypeError, match="float32"):
        kmoe.combine_plain(x, torch.zeros((2, 4, 2), dtype=torch.float64),
                           inv)
    with pytest.raises(TypeError, match="rows"):
        kmoe.combine_plain(x.long(), torch.zeros((2, 4, 2)), inv)
    with pytest.raises(ValueError, match="CUDA"):
        kmoe.combine_cuda(x, torch.zeros((2, 4, 2)), inv)


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_flash_plain_path_at_a_given_scale_equals_sdpa(layout):
    """``ops.flash_attention`` on CPU tensors (the plain version) at
    Granite's 1 / 64 against ``scaled_dot_product_attention`` at that
    scale, forward and gradients; without a scale it is 1 / sqrt(hd)."""
    B, H, KV, T, hd = 2, 6, 2, 33, 64
    g = torch.Generator().manual_seed(9)
    shp = (lambda n: (B, n, T, hd)) if layout == "bhtd" else \
        (lambda n: (B, T, n, hd))
    q = torch.randn(shp(H), generator=g, requires_grad=True)
    k, v = (torch.randn(shp(KV), generator=g, requires_grad=True)
            for _ in range(2))

    def bhtd(t):
        return t if layout == "bhtd" else t.transpose(1, 2)

    def sdpa(scale):
        return bhtd(F.scaled_dot_product_attention(
            bhtd(q), bhtd(k).repeat_interleave(H // KV, 1),
            bhtd(v).repeat_interleave(H // KV, 1), is_causal=True,
            scale=scale))

    for scale in (1 / 64, None):
        got = ops.flash_attention(q, k, v, layout=layout, scale=scale)
        want = sdpa(scale)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        ga = torch.autograd.grad(got.square().sum(), (q, k, v))
        gb = torch.autograd.grad(want.square().sum(), (q, k, v))
        for a, b in zip(ga, gb):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-5)
    assert kflash.softmax_scale(64, None) == 0.125


def test_registered_granite_config_is_left_as_the_reference():
    """The registered config keeps capacity 1.25, an untied unembedding
    and none of the multipliers: its input scale is 1 and its softmax
    scale 1 / sqrt(hd); Gemma's tied sqrt(d) rule stays the default."""
    cfg = get_config("granite-moe-3b-a800m")
    assert cfg.moe == MoESpec(num_experts=40, top_k=8, d_ff_expert=512,
                              capacity_factor=1.25)
    assert (cfg.embed_scale, cfg.residual_scale, cfg.attn_scale,
            cfg.logit_scale) == (None, 1.0, None, 1.0)
    assert cfg.input_scale == 1.0
    assert kflash.softmax_scale(cfg.head_dim, cfg.attn_scale) == 0.125
    gemma = get_config("gemma-2b")
    assert gemma.input_scale == gemma.d_model ** 0.5
