"""Serving on the stacked cluster held against the JAX reference.

The port's serve-side domain run (a model built on ``cluster_ctx(vc,
opts=("serve_fsdp",))`` is a ``ClusterModel``: it takes the cluster's
stacked parameters and runs once per memory domain, ``models.domains``) against the reference's
``vc.run`` of the same body (``tests/test_serving_engine.py``'s recorded-
decoder body: B 3, s_max 16, per-slot positions [0, 3, 1], the reduced
``qwen3-0.6b``), on 2x4 and on the factored ``2x(2x2)`` (tp 2: a T-sharded
cache, split-K decode): the logits and the updated cache at ``F32_TOL``,
from a zero cache and from a random one whose positions reach the second
tp rank's chunk; prefill (the train layout) into the cache.  The hybrid
at tp 2 is ``tests/test_torch_serving_hybrid_tp.py``, through the same
checks.
``RecordedDecoder`` is bit-identical to the sync decode (replay, a new
table, the fallbacks), its schedule holds one gather per fsdp leaf as the
reference's does, and its gathers resolve to ONE node buffer per node.
``materialize_params_on_mesh`` reads pod-replicated windows through the
node tier exactly (no slow-link bytes).  And the repairs: the port's
``FALLBACK`` equals the reference's, the scheduler's live-tuner key
follows the model's communicator and decoder, the single-device engine's
refusal names ``materialize_params_on_mesh``.

The reference's tp-2 prefill cache is not its decode layout (it gathers
T-chunks of different kv-head shards: ROADMAP Queue 3), so the port's tp-2
prefill cache is held to the reference's 2x4 (tp 1) prefill cache, and its
logits to the reference's tp-2 prefill logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.comm import tuning as jtuning
from repro.configs import get_config as jget
from repro.models import build_by_name as jbuild_by_name
from repro.models.transformer import build as jbuild
from repro.runtime.steps import cluster_ctx as jcluster_ctx
from repro.serving.recorded import RecordedDecoder as JRecordedDecoder
from repro.serving.scheduler import (
    ContinuousBatchingScheduler as JScheduler)
from repro.substrate import VirtualCluster as JVC
from repro_torch.analysis.traffic import link_bytes
from repro_torch.comm import Communicator, SharedWindow, tuning
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core import tree as T
from repro_torch.models import build_by_name
from repro_torch.models.domains import node_window
from repro_torch.models.transformer import build
from repro_torch.runtime.steps import cluster_ctx
from repro_torch.serving.engine import (materialize_params,
                                        materialize_params_on_mesh)
from repro_torch.serving.recorded import RecordedDecoder
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.substrate import VirtualCluster
from repro_torch.substrate.cluster import P
from repro_torch.substrate.collectives import recording

F32_TOL = dict(rtol=2e-4, atol=2e-4)
B, S_MAX, T0 = 3, 16, 8
TOK = [[5], [9], [2]]
_PROMPT = np.random.default_rng(1).integers(0, 256, (B, T0 + 1)).astype(
    np.int32)
LABELS = ("2x4", "2x(2x2)")


def _clusters(label):
    if label == "2x4":
        return JVC(pods=2, chips=4), VirtualCluster(pods=2, chips=4,
                                                    device="cpu")
    return (JVC(pods=2, chips=4, fast_axis=("dp", "tp"), fast_shape=(2, 2),
                slow_axis="pod"),
            VirtualCluster.from_label(label, device="cpu"))


def _data(vc, ctx):
    sizes = dict(zip(vc.axis_names, vc.axis_shapes))
    return int(np.prod([sizes[a] for a in ctx.fsdp_axes]))


def _models(label, mode="hier", arch="qwen3-0.6b"):
    """(reference model, its vc, port model, its vc) for the reduced
    ``arch`` in the serve_fsdp layout."""
    jvc, vc = _clusters(label)
    jctx = jcluster_ctx(jvc, opts=("serve_fsdp",))
    jm = jbuild(jget(arch).reduced(), jctx, data=_data(jvc, jctx))
    ctx = cluster_ctx(vc, mode=mode, opts=("serve_fsdp",))
    m = build(get_config(arch).reduced(), ctx, data=_data(vc, ctx),
              device="cpu")
    return jm, jvc, m, vc


def _split_dim(name: str) -> int:
    """The dim of a global unit-stacked cache leaf that tp splits: the
    slots of k / v (U, B, S, kv, hd), the channels of an rglru block's h
    (U, B, dr) and conv (U, B, K-1, dr)."""
    return {"k": 2, "v": 2, "h": 2, "conv": 3}[name]


def _jspecs(jm, serve):
    ctx = jm.ctx
    return tuple(jax.tree.leaves(jm.param_specs(
        serve=serve, tp_axis=ctx.tp_axis, fsdp_axis=ctx.fsdp_axes[0])))


def _pspecs(m, serve=True):
    ctx = m.ctx
    return m.param_specs(serve=serve, tp_axis=ctx.tp_axis,
                         fsdp_axis=ctx.fsdp_axes[0] if ctx.fsdp_axes
                         else None)


def _ranks(cache):
    """A NodeCache's per-rank leaves (R, *local), reference order."""
    out = {}
    for k, v in cache.rank_view().items():
        out[k] = T.tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[3:])),
                            v)
    return out


def _random_cache(jm, seed=4):
    """A random global decode cache per unit leaf: (U, B, S, kv, hd) for
    attention (S the window's ring for a local block), (U, B, dr) /
    (U, B, K-1, dr) for an rglru block's h / conv."""
    cfg = jm.cfg
    rng = np.random.default_rng(seed)
    U, dr = cfg.n_units, cfg.rnn_width
    out = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "rglru":
            shapes = {"h": (U, B, dr),
                      "conv": (U, B, cfg.conv_kernel - 1, dr)}
        else:
            S = min(cfg.window, S_MAX) if kind == "local" else S_MAX
            shapes = dict.fromkeys(("k", "v"),
                                   (U, B, S, cfg.n_kv, cfg.head_dim))
        out[f"b{i}"] = {n: rng.normal(size=sh).astype(np.float32)
                        for n, sh in shapes.items()}
    return out


def _node_cache(m, vc, glob):
    """The port's NodeCache holding the global cache ``glob``: every
    domain's copy, at tp each rank's chunk of the split dim."""
    with vc.bind():
        cache = m.cache_init(B, S_MAX)
    lay = cache.domains
    for key, leaves in glob.items():
        for n, a in leaves.items():
            t = torch.from_numpy(a)
            if lay.tp_dim:
                d = _split_dim(n)
                t = t.unflatten(d, (lay.tp, -1)).movedim(d, 1)
            cache["units"][key][n].copy_(t.expand_as(
                cache["units"][key][n]))
    return cache


def _ref_decode(jm, jvc, jp, posv, glob=None):
    """The reference's decode body on its cluster: logits (B, 1, V) and the
    per-rank new cache leaves (R, U, B, S/tp, kv, hd)."""
    leaves, tdef = jax.tree.flatten(jp)
    tok = jnp.asarray(TOK, jnp.int32)
    pos = jnp.asarray(posv, jnp.int32)
    tp = jm.ctx.tp_axis
    n = len(leaves)

    def body(*args):
        p = jax.tree.unflatten(tdef, args[:n])
        cache = jm.cache_init(B, S_MAX)
        if glob is not None:
            cache = {"units": jax.tree.unflatten(
                jax.tree.structure(cache["units"]), list(args[n:]))}
        c, lg = jm.decode_fn(p, cache, tok, pos)
        return (lg,) + tuple(x[None] for x in jax.tree.leaves(c))

    extra, cspecs = [], []
    for key in sorted(glob or {}):
        for name in sorted(glob[key]):
            extra.append(jnp.asarray(glob[key][name]))
            cspecs.append(JP(*(None,) * _split_dim(name) + (tp,)) if tp
                          else JP())
    n_out = len(jax.tree.leaves(jm.cache_init(B, S_MAX)))
    out = jvc.run(body, *leaves, *extra,
                  in_specs=_jspecs(jm, True) + tuple(cspecs),
                  out_specs=(JP(),) + (JP(jvc.axis_names),) * n_out)
    return [np.asarray(x) for x in out]


def _port_decode(m, vc, params, posv, cache=None, decode=None):
    decode = decode or m.decode_fn
    lay = vc.layout(params, _pspecs(m))
    tok = vc.layout(torch.tensor(TOK), P())
    pos = vc.layout(torch.tensor(posv), P())
    with vc.bind():
        cache = m.cache_init(B, S_MAX) if cache is None else cache
        with recording() as rec:
            cache, lg = decode(lay, cache, tok, pos)
    return lg, cache, rec


POSV = {"zero-cache": [0, 3, 1], "random-cache": [9, 12, 15]}


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("posv", list(POSV.values()), ids=list(POSV))
def test_cluster_decode_matches_reference(label, posv):
    check_decode(label, posv, "qwen3-0.6b")


def check_decode(label, posv, arch):
    """Decode on ``label`` against the reference's: from a zero cache
    (``posv[0] == 0``) or a random one."""
    jm, jvc, m, vc = _models(label, arch=arch)
    jp = jm.init_params(0)
    glob = None if posv[0] == 0 else _random_cache(jm)
    want = _ref_decode(jm, jvc, jp, posv, glob)
    params = params_from_reference(jp, device="cpu")
    cache = None if glob is None else _node_cache(m, vc, glob)
    lg, cache, _ = _port_decode(m, vc, params, posv, cache)
    assert lg.shape == (vc.num_devices, B, 1, m.cfg.vocab_padded)
    np.testing.assert_allclose(lg[0].numpy(), want[0], **F32_TOL)
    got = T.leaves(_ranks(cache))
    assert len(got) == len(want) - 1
    for g, w in zip(got, want[1:]):
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL)
    # one cache per node, handed to the ranks as a broadcast view
    leaf = T.leaves(dict(cache))[0]
    assert leaf.shape[0] == vc.pods and cache.domains.count == vc.pods
    assert T.leaves(cache.rank_view())[0].stride(1) == 0


@functools.lru_cache(maxsize=None)
def _ref_prefill(label, arch):
    """The reference's prefill on ``label`` of ``_PROMPT``: logits and the
    per-rank cache leaves."""
    jm, jvc, _, _ = _models(label, arch=arch)
    leaves, tdef = jax.tree.flatten(jm.init_params(0))

    def body(*args):
        p = jax.tree.unflatten(tdef, args[:-1])
        c, lg = jm.prefill_fn(p, {"tokens": args[-1]}, S_MAX)
        return (lg,) + tuple(x[None] for x in jax.tree.leaves(c))

    n_out = len(jax.tree.leaves(jm.cache_init(B, S_MAX)))
    out = jvc.run(body, *leaves, jnp.asarray(_PROMPT),
                  in_specs=_jspecs(jm, False) + (JP(),),
                  out_specs=(JP(),) + (JP(jvc.axis_names),) * n_out)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("label", LABELS)
def test_cluster_prefill_matches_reference(label):
    check_prefill(label, "qwen3-0.6b")


def check_prefill(label, arch):
    """Prefill on ``label`` against the reference's logits there and its
    tp-1 cache, then decode from the cache against decode from the port's
    tp-1 prefill cache."""
    jm, _, m, vc = _models(label, arch=arch)
    jp = jm.init_params(0)
    toks = _PROMPT
    want_lg = _ref_prefill(label, arch)[0]
    tp1 = _models("2x4", arch=arch)
    want = _ref_prefill("2x4", arch)[1:]           # tp 1: every leaf whole
    params = params_from_reference(jp, device="cpu")
    lay = vc.layout(params, _pspecs(m, serve=False))
    with vc.bind():
        cache, lg = m.prefill_fn(lay, {"tokens": vc.layout(
            torch.from_numpy(toks), P())}, S_MAX)
    np.testing.assert_allclose(lg[0].numpy(), want_lg, **F32_TOL)
    tp = cache.domains.tp
    names = [n for k in sorted(cache["units"])
             for n in sorted(cache["units"][k])]
    for g, w, n in zip(T.leaves(_ranks(cache)), want, names):
        # a rank's chunk of the global leaf (every rank's whole at tp 1)
        d = _split_dim(n) + 1
        full = w.reshape(w.shape[:d] + (tp, -1) + w.shape[d + 1:])
        np.testing.assert_allclose(
            g.numpy(), np.stack([np.take(full[r], r % tp, axis=d - 1)
                                 for r in range(vc.num_devices)]),
            **F32_TOL)
    # the T-sharded cache decodes as the tp-1 one does
    posv = [T0, T0, T0]
    lg_tp, _, _ = _port_decode(m, vc, params, posv, cache)
    m1, vc1 = tp1[2], tp1[3]
    with vc1.bind():
        cache1, _ = m1.prefill_fn(vc1.layout(params, _pspecs(m1, False)),
                                  {"tokens": vc1.layout(
                                      torch.from_numpy(toks), P())}, S_MAX)
    lg_1, _, _ = _port_decode(m1, vc1, params, posv, cache1)
    np.testing.assert_allclose(lg_tp[0].numpy(), lg_1[0].numpy(),
                               **F32_TOL)


def _ref_gathers():
    """The reference RecordedDecoder's gather count on 2x4."""
    jm, jvc, _, _ = _models("2x4")
    jp = jm.init_params(0)
    leaves, tdef = jax.tree.flatten(jp)
    dec = JRecordedDecoder(jm)

    def body(*pl):
        p = jax.tree.unflatten(tdef, pl)
        return dec(p, jm.cache_init(B, S_MAX), jnp.asarray(TOK, jnp.int32),
                   jnp.asarray([0, 3, 1], jnp.int32))[1]

    jvc.run(body, *leaves, in_specs=_jspecs(jm, True), out_specs=JP())
    (sched,) = dec.schedules.values()
    return sum(n.family == "gather" for n in sched.graph.nodes)


@pytest.mark.parametrize("label", LABELS)
def test_recorded_decoder_bit_identical_and_replays(label):
    jm, _, m, vc = _models(label)
    params = params_from_reference(jm.init_params(0), device="cpu")
    glob = _random_cache(jm)
    posv = [9, 12, 15]
    lg, cache, rec = _port_decode(m, vc, params, posv,
                                  _node_cache(m, vc, glob))
    dec = RecordedDecoder(m)
    lg2, cache2, rec2 = _port_decode(m, vc, params, posv,
                                     _node_cache(m, vc, glob), dec)
    assert torch.equal(lg, lg2) and torch.isfinite(lg).all()
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(cache),
                                                 T.leaves(cache2)))
    # the same traffic: the recorded reads price as the eager ones
    assert link_bytes(rec) == link_bytes(rec2)
    (sig, sched), = dec.schedules.items()
    assert sig == ((vc.num_devices, B, 1), "torch.int64", 2)
    n_fsdp = sum(mt.fsdp_dim is not None for mt in T.leaves(m.serve_defs))
    gathers = [n for n in sched.graph.nodes if n.family == "gather"]
    assert len(gathers) == n_fsdp > 0 and all(n.node for n in gathers)
    if label == "2x4":
        assert len(gathers) == _ref_gathers()
    lg3, _, _ = _port_decode(m, vc, params, posv, _node_cache(m, vc, glob),
                             dec)                  # replay
    assert torch.equal(lg, lg3) and len(dec.schedules) == 1
    dec.set_table(None)
    assert dec.schedules == {}


def test_recorded_gathers_resolve_to_one_node_buffer():
    """A recorded gather reads ONE buffer per node, never each rank's
    copy: the node buffers of a leaf are (pods, *full)."""
    _, _, m, vc = _models("2x4")
    params = vc.layout(m.init_params(0), _pspecs(m))
    with vc.bind():
        w = params["units"]["b0"]["attn"]["wq"]
        dim = m.serve_defs["units"]["b0"]["attn"]["wq"].fsdp_dim
        win = node_window(m.ctx, w, dim, True)
        rec = m.ctx.comm.record()
        ref = rec.gather(win, key="wq", node=True)
        out = rec.run()[ref]
    full = m.init_params(0)["units"]["b0"]["attn"]["wq"]
    assert out.shape == (vc.pods,) + tuple(full.shape)
    assert all(torch.equal(out[d], full) for d in range(vc.pods))


def test_recorded_decoder_fallbacks():
    """No window store: RecordedDecoder IS model.decode_fn — a single
    device, and naive mode on the cluster."""
    qwen = build_by_name("qwen3-0.6b", reduced=True, device="cpu")
    params = qwen.init_params(0)
    tok = torch.tensor([[1], [2]])
    dec = RecordedDecoder(qwen)
    _, a = dec(params, qwen.cache_init(2, 8), tok, torch.tensor([0, 3]))
    _, b = qwen.decode_fn(params, qwen.cache_init(2, 8), tok,
                          torch.tensor([0, 3]))
    assert torch.equal(a, b) and dec.schedules == {}
    jm, _, m, vc = _models("2x4", mode="naive")
    params = params_from_reference(jm.init_params(0), device="cpu")
    dec = RecordedDecoder(m)
    lg, _, _ = _port_decode(m, vc, params, [0, 3, 1])
    lg2, cache, _ = _port_decode(m, vc, params, [0, 3, 1], decode=dec)
    assert torch.equal(lg, lg2) and dec.schedules == {}
    assert cache.domains.count == vc.num_devices     # a cache per rank


VC2 = VirtualCluster(pods=2, chips=4, device="cpu")
VC42 = VirtualCluster(pods=4, chips=2, device="cpu")
TUPLE = VirtualCluster(pods=2, chips=4, fast_axis=("dp", "tp"),
                       fast_shape=(2, 2), slow_axis="pod", device="cpu")


@pytest.mark.parametrize("vc", [VC2, VC42, TUPLE], ids=lambda c: c.label)
def test_materialize_params_on_mesh_pod_replicated_windows(vc):
    """A multi-pod window is pod-replicated: the read goes through the node
    tier and hands back the NODE buffer, with no bridge bytes."""
    comm = Communicator.from_cluster(vc)
    assert comm.slow_axis is not None and comm.pods > 1
    buf = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    w = torch.from_numpy(np.concatenate([buf] * vc.pods, axis=0))
    with recording() as rec:
        out = materialize_params_on_mesh(
            {"w": SharedWindow(comm, w, axis=0, epoch=1),
             "b": torch.ones(3)}, vc)
    assert torch.equal(out["w"], torch.from_numpy(buf))
    assert torch.equal(out["b"], torch.ones(3))
    fast, slow = link_bytes(rec)
    assert slow == 0 and fast > 0
    with pytest.raises(ValueError, match="dirty"):
        materialize_params_on_mesh(
            {"w": SharedWindow(comm, w, epoch=1, dirty=True)}, vc)
    with pytest.raises(ValueError, match="static"):
        materialize_params_on_mesh(
            {"w": SharedWindow(Communicator(fast_axis=comm.fast_axis,
                                            slow_axis=comm.slow_axis,
                                            chips=vc.chips), w)}, vc)
    one = Communicator(fast_axis="data", pods=1, chips=1)
    assert materialize_params_on_mesh(
        {"w": SharedWindow(one, w)}, vc)["w"] is w


# ---------------------------------------------------------------------------
# The repairs
# ---------------------------------------------------------------------------

def test_fallback_tables_match_reference():
    assert tuning.FALLBACK == jtuning.FALLBACK
    for cls in (None, "shared", "replicated"):
        assert tuning.FALLBACK[cls] == jtuning.FALLBACK[cls]
    assert tuning.LOSSY_FALLBACK == jtuning.LOSSY_FALLBACK
    assert tuning.FALLBACK[None]["serving"] == "sync"
    assert tuning.FALLBACK["replicated"]["step_time"] == "prefetch"


class _OnCluster:
    """A model whose ctx carries a communicator with static counts."""

    def __init__(self, model, comm):
        self._model = model
        self.ctx = type("Ctx", (), {"comm": comm})()

    def __getattr__(self, name):
        return getattr(self._model, name)


def test_tuner_key_follows_the_communicator_and_the_decoder():
    qwen = build_by_name("qwen3-0.6b", reduced=True, device="cpu")
    params = qwen.init_params(0)
    key = ContinuousBatchingScheduler(qwen, params, slots=2,
                                      s_max=16)._tuner_key
    jqwen = jbuild_by_name("qwen3-0.6b", reduced=True)
    jkey = JScheduler(jqwen, jqwen.init_params(0), slots=2,
                      s_max=16)._tuner_key
    assert key == jkey == dict(pods=1, chips=1, nbytes=key["nbytes"],
                               scheme="sync")
    comm = Communicator.from_cluster(VC2)
    wrapped = _OnCluster(qwen, comm)
    key = ContinuousBatchingScheduler(
        wrapped, params, slots=2, s_max=16,
        decode_fn=RecordedDecoder(qwen))._tuner_key
    assert (key["pods"], key["chips"], key["scheme"]) == (2, 4, "recorded")


def test_single_device_engine_refusal_names_the_mesh_read():
    comm = Communicator.from_cluster(VC2)
    win = SharedWindow(comm, torch.ones(8, 3), epoch=1)
    with pytest.raises(ValueError, match="materialize_params_on_mesh") as e:
        materialize_params({"w": win})
    assert "item 17" not in str(e.value)
