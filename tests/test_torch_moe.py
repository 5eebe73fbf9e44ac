"""The port's MoE block (``repro_torch.models.moe``) held against the JAX
reference on the CPU.

The same numpy inputs go to both packages.  ``route`` keeps
``lax.top_k``'s order (ties included); ``dispatch_tables`` matches
exactly (integers) over a seeded sweep of N, k, E, capacity and expert
group, and holds the reference's property invariants
(``tests/test_moe_dispatch.py``); the batched form (a tp axis with an
expert group per rank, a member axis) equals the reference per row.  The
gather combine adds each token's contributions in ascending expert order,
bit for bit the reference's scatter-add order, and its gradients are the
autograd of a scatter-add's.  ``expert_ffn``, ``aux_load_balance_loss``,
and ``moe_block`` (train and serve) agree within ``F32_TOL`` on one device
— at the configs' own ``capacity_factor`` 1.25, where tokens drop — and
at tp 2 and tp 8 (``tp_ff`` 2) inside the reference's ``shard_map``.  The
MoE configs' meta trees and specs equal the reference's at full width;
the reduced configs' prefill, per-slot decode and loss match, and decode
continues prefill as the reference's own test asks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs.base import MoESpec as JMoESpec
from repro.models import build as jbuild
from repro.models import meta as jmeta
from repro.models import moe as jmoe
from repro.models.parallel import ParallelCtx as JCtx
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.configs.base import MoESpec
from repro_torch.convert import params_from_reference
from repro_torch.models import ParallelCtx, build, build_by_name, make_batch
from repro_torch.models import layers, meta, moe
from repro_torch.substrate import VirtualCluster

F32_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
CTX = ParallelCtx.single()
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _jtables(idx, e0, n_local, capacity):
    return [np.asarray(a) for a in jax.jit(
        jmoe.dispatch_tables, static_argnames=("e0", "n_local", "capacity"))(
        jnp.asarray(idx), e0=e0, n_local=n_local, capacity=capacity)]


# ---------------------------------------------------------------------------
# route / dispatch tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
def test_route_matches_reference_order(ties):
    rng = np.random.default_rng(0)
    h = rng.normal(size=(33, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    if ties:              # whole rows of equal logits: the lower id first
        w[:, 1:] = w[:, :1]
        h[::3] = 0.0
    jidx, jgate = jmoe.route(jnp.asarray(h), jnp.asarray(w), 3)
    idx, gate = moe.route(torch.from_numpy(h), torch.from_numpy(w), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-6,
                               atol=1e-7)


# (N, k, E, capacity, e0, n_local): one expert group (e0 = 0, n_local = E),
# groups of an ep split, capacities that drop and that do not
SWEEP = [(N, k, E, C, e0, nl)
         for N, k, E in ((1, 1, 2), (7, 2, 4), (33, 3, 8), (50, 8, 40))
         for C in (1, int(N * k / E * 1.25) + 1, N * k)
         for e0, nl in ((0, E), (E // 2, E // 2))]


@pytest.mark.parametrize("N,k,E,C,e0,nl", SWEEP)
def test_dispatch_tables_exact_and_invariants(N, k, E, C, e0, nl):
    rng = np.random.default_rng(N * 131 + k * 17 + E + C)
    idx = rng.integers(0, E, size=(N, k)).astype(np.int32)
    want_t, want_s = _jtables(idx, e0, nl, C)
    table, slot = moe.dispatch_tables(torch.from_numpy(idx), e0=e0,
                                      n_local=nl, capacity=C)
    np.testing.assert_array_equal(table.numpy(), want_t)
    np.testing.assert_array_equal(slot.numpy(), want_s)
    # the reference's invariants (tests/test_moe_dispatch.py), per group
    table, slot, flat = table.numpy(), slot.numpy(), idx.reshape(-1)
    real = table < N
    assert np.all((slot >= 0) == real)
    for e in range(nl):
        for c in np.nonzero(real[e])[0]:
            s = slot[e, c]
            assert s // k == table[e, c] and flat[s] == e0 + e
        count = int((flat == e0 + e).sum())
        assert real[e].sum() == min(count, C)
        assert not np.any(~real[e, :-1] & real[e, 1:])   # fill from left
    used = slot[slot >= 0]
    assert len(np.unique(used)) == len(used)


def test_dispatch_tables_batched_over_ranks_and_members():
    """Leading dims (tp 4, members 3), an expert group per tp rank: each
    row equals the reference's table of its own group."""
    rng = np.random.default_rng(5)
    N, k, E, nl, C = 20, 2, 8, 2, 4
    idx = rng.integers(0, E, size=(4, 3, N, k)).astype(np.int32)
    e0 = torch.arange(4).reshape(4, 1) * nl
    table, slot = moe.dispatch_tables(torch.from_numpy(idx), e0=e0,
                                      n_local=nl, capacity=C)
    assert table.shape == (4, 3, nl, C)
    for r in range(4):
        for m in range(3):
            want_t, want_s = _jtables(idx[r, m], r * nl, nl, C)
            np.testing.assert_array_equal(table[r, m].numpy(), want_t)
            np.testing.assert_array_equal(slot[r, m].numpy(), want_s)


def test_ep_tp_factorization_matches_reference():
    for tp in range(1, 33):
        for E in (2, 3, 4, 40, 128):
            assert MoESpec(E, 2, 64).ep_tp(tp) == JMoESpec(E, 2, 64).ep_tp(tp)


# ---------------------------------------------------------------------------
# expert ffn, the gather combine, the auxiliary loss
# ---------------------------------------------------------------------------

def test_expert_ffn_matches_reference():
    rng = np.random.default_rng(2)
    buf = rng.normal(size=(4, 5, 16)).astype(np.float32)
    w_in = rng.normal(size=(4, 16, 2, 8)).astype(np.float32) * 0.2
    w_out = rng.normal(size=(4, 8, 16)).astype(np.float32) * 0.2
    for act in ("swiglu", "geglu"):
        want = jmoe.expert_ffn(jnp.asarray(buf), jnp.asarray(w_in),
                               jnp.asarray(w_out), act)
        got = moe.expert_ffn(torch.from_numpy(buf), torch.from_numpy(w_in),
                             torch.from_numpy(w_out), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a member axis shares the weights
    two = np.stack([buf, buf[:, ::-1]])
    got = moe.expert_ffn(torch.from_numpy(two), torch.from_numpy(w_in),
                         torch.from_numpy(w_out), "swiglu")
    one = moe.expert_ffn(torch.from_numpy(buf[:, ::-1].copy()),
                         torch.from_numpy(w_in), torch.from_numpy(w_out),
                         "swiglu")
    np.testing.assert_allclose(got[1].numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("C", [2, 40])
def test_gather_combine_is_the_scatter_add_in_expert_order(C):
    """dispatch / combine against the reference's arithmetic: the buffers
    bit for bit, each token's sum in the scatter-add's ascending-expert
    order bit for bit, and the gradients of both against the autograd of
    ``index_select`` / ``index_add`` (the scatter form)."""
    rng = np.random.default_rng(7)
    N, k, E, d = 16, 3, 6, 5
    idx = torch.from_numpy(rng.integers(0, E, size=(N, k)))
    gate = torch.softmax(torch.from_numpy(rng.normal(
        size=(N, k)).astype(np.float32)), -1).requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=(N, d)).astype(
        np.float32)).requires_grad_(True)
    table, slot = moe.dispatch_tables(idx, e0=0, n_local=E, capacity=C)
    inv, perm, back = moe.combine_tables(slot, N, k)
    buf = moe.dispatch(x, table, inv)
    out = buf * 1.5 + 0.25
    y = moe.combine(out, gate, inv, perm, back)

    # the scatter form, as the reference computes it
    x2 = x.detach().clone().requires_grad_(True)
    g2 = gate.detach().clone().requires_grad_(True)
    pad = torch.cat([x2, x2.new_zeros(1, d)])
    buf2 = pad.index_select(0, table.reshape(-1)).reshape(E, C, d)
    gflat = torch.cat([g2.reshape(-1), g2.new_zeros(1)])
    gsel = torch.where(slot >= 0, gflat[slot.clamp_min(0)],
                       torch.zeros(()))
    out2 = (buf2 * 1.5 + 0.25) * gsel[..., None]
    y2 = torch.zeros(N + 1, d)
    for r, row in zip(table.reshape(-1).tolist(), out2.reshape(-1, d)):
        y2 = y2.index_add(0, torch.tensor([r]), row[None])  # in (e, c) order
    y2 = y2[:N]
    assert torch.equal(buf, buf2)
    assert torch.equal(y, y2)
    if C == 2:
        assert int((slot >= 0).sum()) < N * k            # drops happened
    ct = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
    ga = torch.autograd.grad(y, (x, gate), ct)
    gb = torch.autograd.grad(y2, (x2, g2), ct)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 8, size=(40, 2)).astype(np.int32)
    gate = rng.random(size=(40, 2)).astype(np.float32)
    want = jmoe.aux_load_balance_loss(jnp.asarray(idx), jnp.asarray(gate), 8)
    got = moe.aux_load_balance_loss(torch.from_numpy(idx),
                                    torch.from_numpy(gate), 8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# moe_block on one device and at tp
# ---------------------------------------------------------------------------

def _block_cfg(E=4, k=2, cf=1.25, d=16, dff=8):
    cfg = configs.get_config("granite-moe-3b-a800m").reduced(d_model=d)
    return dataclasses.replace(cfg, moe=MoESpec(E, k, dff, cf))


def _jcfg(cfg):
    return dataclasses.replace(
        jconfigs.get_config(cfg.name).reduced(d_model=cfg.d_model),
        moe=JMoESpec(cfg.moe.num_experts, cfg.moe.top_k,
                     cfg.moe.d_ff_expert, cfg.moe.capacity_factor))


def _block_params(cfg, tp, serve, seed=1):
    defs = jmeta.moe_defs(_jcfg(cfg), tp, serve)
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=m.shape) * (0.5 if k != "ln" else 0.1))
         .astype(np.float32) for k, m in defs.items()}
    p["router"][:, 0] += 0.6      # expert 0 favoured: its slots overflow
    return p, defs


def _drops(cfg, x, p, tp=1):
    """Routing assignments the capacity drops, over every group."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    N = x.shape[0] * x.shape[1]
    h = layers.rms_norm(torch.from_numpy(x.reshape(N, -1)),
                        torch.from_numpy(p["ln"]), cfg.norm_eps)
    idx, _ = moe.route(h, torch.from_numpy(p["router"]), k)
    C = int(N * k / E * cfg.moe.capacity_factor) + 1
    table, _ = moe.dispatch_tables(idx, e0=0, n_local=E, capacity=C)
    return N * k - int((table < N).sum())


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_block_matches_reference_on_one_device(serve, cf):
    cfg = _block_cfg(cf=cf)
    p, defs = _block_params(cfg, 1, serve)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 1 if serve else 12, 16)).astype(np.float32) + 1
    if cf == 1.25 and not serve:
        assert _drops(cfg, x, p) > 0
    jctx = JCtx.single()
    want = jax.jit(lambda xx, pp: jmoe.moe_block(
        xx, pp, defs, jctx, _jcfg(cfg), serve=serve))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    got = moe.moe_block(xt, pt, meta.moe_defs(cfg, 1, serve), CTX, cfg,
                        serve=serve)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    # gradients: jax.grad of the reference's block
    ct = rng.normal(size=x.shape).astype(np.float32)

    def jloss(xx, pp):
        return jnp.sum(jmoe.moe_block(xx, pp, defs, jctx, _jcfg(cfg),
                                      serve=serve) * ct)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    tg = torch.autograd.grad((got * torch.from_numpy(ct)).sum(),
                             [xt] + [pt[k] for k in sorted(pt)])
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), **F32_TOL)
    for g, key in zip(tg[1:], sorted(pt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[1][key]),
                                   **F32_TOL)


@pytest.mark.parametrize("tp,E,serve", [
    (2, 4, False), (2, 3, False), (8, 4, False), (2, 4, True),
    (8, 4, True)])
def test_moe_block_matches_reference_at_tp(tp, E, serve):
    """Inside the reference's ``shard_map`` on a 1x(1x``tp``) cluster
    against the port over the stacked ranks: tp 2 at E 4 (ep 2), at E 3
    (ep 1, tp_ff 2), and tp 8 at E 4 (ep 4, tp_ff 2); train (capacity
    1.25, drops) and serve."""
    cfg = _block_cfg(E=E)
    ep, tp_ff = cfg.moe.ep_tp(tp)
    p, defs = _block_params(cfg, tp, serve)
    kw = dict(pods=1, chips=tp, fast_axis=("dp", "tp"), fast_shape=(1, tp),
              slow_axis="pod")
    jvc, vc = JVC(**kw), VirtualCluster(device="cpu", **kw)
    rng = np.random.default_rng(9)
    T = 1 if serve else 4 * tp
    x = rng.normal(size=(2, T, 16)).astype(np.float32) + 1
    if not serve:
        assert _drops(cfg, x, p) > 0
    jctx = JCtx(tp_axis="tp", tp=tp, compute_dtype=jnp.float32)
    jspecs = jmeta.param_specs(defs, _jcfg(cfg), tp_axis="tp",
                               fsdp_axis=None)
    xspec = JP() if serve else JP(None, "tp")
    names = sorted(p)

    def body(xx, *leaves):
        y = jmoe.moe_block(xx, dict(zip(names, leaves)), defs, jctx,
                           _jcfg(cfg), serve=serve)
        return y[None]

    want = np.asarray(jax.jit(jvc.smap(
        body, (xspec,) + tuple(jspecs[n] for n in names),
        JP(jvc.axis_names)))(jnp.asarray(x), *[jnp.asarray(p[n])
                                               for n in names]))
    ctx = ParallelCtx(tp_axis="tp", tp=tp, compute_dtype=torch.float32)
    tdefs = meta.moe_defs(cfg, tp, serve)
    tspecs = meta.param_specs(tdefs, cfg, tp_axis="tp", fsdp_axis=None)
    from repro_torch.substrate.cluster import P
    with vc.bind():
        xt = vc.layout(torch.from_numpy(x), P() if serve else P(None, "tp"))
        pt = {n: vc.layout(torch.from_numpy(p[n]), tspecs[n]) for n in names}
        got = moe.moe_block(xt, pt, tdefs, ctx, cfg, serve=serve)
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape),
                               **F32_TOL)
    assert (ep, tp_ff) == {(2, 4): (2, 1), (2, 3): (1, 2),
                           (8, 4): (4, 2)}[(tp, E)]


# ---------------------------------------------------------------------------
# meta trees, specs, the reduced models
# ---------------------------------------------------------------------------

def _meta_rows(defs, mod):
    out = {}

    def walk(t, path):
        if isinstance(t, mod.PMeta):
            out[path] = (tuple(t.shape), t.tp_dim, t.fsdp_dim, t.data_dim,
                         t.init)
            return
        for k in t:
            walk(t[k], path + (k,))
    walk(defs, ())
    return out


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("serve,opts", [(False, ()), (True, ()),
                                        (True, ("serve_fsdp",))])
def test_moe_model_defs_and_specs_match_reference_at_full_width(name, serve,
                                                                opts):
    """The full-width meta trees (no memory) and their specs at tp 1 / 2 /
    16, data 4, both modes.  Under ``serve_fsdp`` the reference's spec of
    a ``data_dim`` leaf names the store axis twice (JAX refuses it); the
    port stores it along the ``data_dim`` alone."""
    jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
    for tp in (1, 2, 16):
        for mode in ("hier", "naive"):
            jd = jmeta.model_defs(jcfg, tp, 4, mode, serve=serve,
                                  opts=frozenset(opts))
            td = meta.model_defs(cfg, tp, 4, mode, serve=serve,
                                 opts=frozenset(opts))
            assert _meta_rows(td, meta) == _meta_rows(jd, jmeta)
            js = jmeta.param_specs(jd, jcfg, tp_axis="tp", fsdp_axis="data")
            ts = meta.param_specs(td, cfg, tp_axis="tp", fsdp_axis="data")
            for key, row in _meta_rows(td, meta).items():
                ts_leaf, js_leaf = ts, js
                for k in key:
                    ts_leaf, js_leaf = ts_leaf[k], js_leaf[k]
                want = tuple(js_leaf)
                if row[2] is not None and row[3] is not None:
                    off = int(key[0] == "units")
                    want = list(want)
                    want[row[2] + off] = None      # the data_dim alone
                    want = tuple(want)
                    assert tuple(js_leaf).count("data") == 2
                assert tuple(ts_leaf) == want, key
    # the expert leaves at full width: (tp, E_loc, d, 2, n_ff)
    d = meta.model_defs(cfg, 2, 4, "hier")["units"]["b0"]["moe"]
    ep, tp_ff = cfg.moe.ep_tp(2)
    assert d["w_in"].shape == (2, cfg.moe.num_experts // ep, cfg.d_model, 2,
                               cfg.moe.d_ff_expert // tp_ff)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_param_count_and_init_params_tree(name):
    cfg = configs.get_config(name)
    m = build(cfg, CTX, device="meta")
    n = sum(t.numel() for t in jax.tree.leaves(
        m.abstract_params(m.param_specs())))
    jd = jmeta.model_defs(jconfigs.get_config(name), 1, 1, "hier")
    want = sum(int(np.prod(mt.shape)) * (cfg.n_units if p[0].key == "units"
                                         else 1)
               for p, mt in jax.tree_util.tree_leaves_with_path(
                   jd, is_leaf=lambda x: isinstance(x, jmeta.PMeta)))
    assert n == want
    if name == "granite-moe-3b-a800m":      # 13.50 GB of f32
        assert n == 3_374_679_552 and cfg.param_count() == 3_374_392_320
    red = build_by_name(name, reduced=True, device="cpu")
    jm = jbuild(jconfigs.get_config(name).reduced(), JCtx.single())
    tp_ = red.init_params(0)
    jp = jm.init_params(0)
    assert [a.shape for a in jax.tree.leaves(jp)] == \
        [tuple(b.shape) for b in jax.tree.leaves(tp_)]


def _pair(name):
    jcfg = jconfigs.get_config(name).reduced()
    jm = jbuild(jcfg, JCtx.single())
    jp = jm.init_params(0)
    tm = build(configs.get_config(name).reduced(), CTX, device="cpu")
    return jm, jp, tm, params_from_reference(jax.tree.map(np.asarray, jp),
                                             "cpu")


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_prefill_decode_and_loss_match_reference(name):
    jm, jp, tm, tp = _pair(name)
    rng = np.random.default_rng(4)
    B, T, s_max = 3, 12, 20
    toks = rng.integers(0, tm.cfg.vocab, size=(B, T + 1)).astype(np.int32)
    jc, jl = jax.jit(lambda p, b: jm.prefill_fn(p, b, s_max))(
        jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, s_max)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        np.testing.assert_allclose(_np(b), _np(a), **F32_TOL)
    pos = np.array([T, T - 5, T - 1], np.int32)
    tok = rng.integers(0, tm.cfg.vocab, size=(B, 1)).astype(np.int32)
    decode = jax.jit(jm.decode_fn)
    for _ in range(3):
        jc, jl = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tc, tl = tm.decode_fn(tp, tc, torch.from_numpy(tok),
                              torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        pos = pos + 1
    jn, jcnt = jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(toks)})
    tn, tcnt = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tn.item(), float(jn), rtol=2e-4)
    assert tcnt.item() == float(jcnt)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_matches_prefill(name):
    """The reference's ``test_decode_matches_prefill`` for the MoE configs
    in the port (reduced, its own 0.05 tolerance: capacity drops differ
    between the prefill's and the decode's token counts)."""
    T, T0 = 32, 16
    m = build_by_name(name, reduced=True, device="cpu")
    params = m.init_params(0)
    batch = make_batch(m.cfg, B=2, T=T, device="cpu")
    _, ref_logits = m.prefill_fn(params, batch, T)
    cache, logits = m.prefill_fn(params, {"tokens": batch["tokens"][
        :, :T0 + 1]}, T)
    for i in range(T0, T):
        cache, logits = m.decode_fn(params, cache,
                                    batch["tokens"][:, i:i + 1], i)
    err = float((logits - ref_logits).abs().max())
    scale = float(ref_logits.abs().max()) + 1e-9
    assert err / scale < 0.05, (name, err / scale)
