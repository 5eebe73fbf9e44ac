"""The port's lossy wire formats held against the JAX reference.

Same numpy inputs (from a seed) go to ``repro.comm.quantize`` /
``repro.comm.Communicator`` and to their ``repro_torch`` counterparts on the
CPU.  The reference runs compiled (``jax.jit``), as its collectives always
do; XLA turns its division by the constant ``qmax`` into a product with the
f32 reciprocal, and the port computes scales that way, so codes, scales and
packed int4 bytes are held bit for bit.  Gathers match bit for bit, sums
within rtol 1e-5 / atol 1e-6 (the reduction order differs), products within
1e-5.  ``stochastic=True`` draws its noise from a ``torch.Generator``, so it
is held to unbiasedness, not to JAX's bits.  The q4 CUDA kernel itself is
checked on the card by ``tests/test_torch_gpu.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.comm import Communicator as JComm
from repro.comm import quantize as jqz
from repro.comm import registry as jregistry
from repro.comm import tuning as jtuning
from repro.kernels import ops as jops
from repro.substrate import default_matrix as jmatrix
from repro_torch.analysis import traffic
from repro_torch.comm import Communicator, registry, tuning
from repro_torch.comm import quantize as qz
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import lru_scan as klru
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops
from repro_torch.kernels import quant as kquant
from repro_torch.substrate import default_matrix
from repro_torch.substrate import collectives as coll

PAIRS = {t.label: (j, t) for j, t in zip(jmatrix(), default_matrix(
    device="cpu"))}
LABELS = list(PAIRS)
LOSSY_CASES = [(f, s.name) for f in ("psum", "allgather")
               for s in registry.schemes_for(f) if s.precision == "lossy"]


def _jrun(jvc, body, *args, out_specs=None):
    out_specs = jvc.spec if out_specs is None else out_specs
    return jax.jit(jvc.smap(body, (jvc.spec,) * len(args), out_specs))(
        *[jnp.asarray(a) for a in args])


def _tile_rows(a, vc):
    """Every pod holds the same row shards (the reference's test layout)."""
    return np.tile(a.reshape(vc.chips, -1, a.shape[-1]),
                   (vc.pods, 1, 1)).reshape(-1, a.shape[-1])


def _one_scale_amax(qmax: float) -> np.float32:
    """An f32 amax whose compiled scale ``amax * f32(1 / qmax)`` is exactly
    1.0, so payload values k + 0.5 are exact rounding ties."""
    recip = np.float32(1.0) / np.float32(qmax)
    amax = np.float32(qmax)
    for _ in range(64):
        if np.float32(amax * recip) == np.float32(1.0):
            return amax
        amax = np.nextafter(amax, np.float32(np.inf))
    raise AssertionError("no amax with a unit scale")


# ---------------------------------------------------------------------------
# codecs: bit for bit against the compiled reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,qmax", [(64, qz.Q8_MAX), (256, qz.Q8_MAX),
                                        (64, qz.Q4_MAX), (100, qz.Q8_MAX)])
def test_block_quantize_bit_equal_to_reference(block, qmax):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1000,)).astype(np.float32)
    x[3] = 1e4                                   # outlier in block 0
    ties = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    x[block:block + 1] = _one_scale_amax(qmax)   # block 1: unit scale
    x[block + 1:block + 1 + ties.size] = ties
    jq, js = jax.jit(lambda v: jqz.block_quantize(
        v, block=block, qmax=qmax)[:2])(jnp.asarray(x))
    q, s, meta = qz.block_quantize(torch.from_numpy(x)[None], block=block,
                                   qmax=qmax)
    np.testing.assert_array_equal(q[0].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s[0].numpy(), np.asarray(js))
    assert s[0, 1].item() == 1.0
    # round half to even at the ties
    np.testing.assert_array_equal(
        q[0].reshape(-1)[block + 1:block + 1 + ties.size].numpy(),
        [0, 2, 2, 0, -2, 4])
    jdeq = jax.jit(lambda a, b: jqz.block_dequantize(
        a, b, (1000, min(block, 1000)), (1000,)))(jq, js)
    deq = qz.block_dequantize(q, s, meta, (1, 1000))
    np.testing.assert_array_equal(deq[0].numpy(), np.asarray(jdeq))


def test_int4_pack_unpack_bit_equal_to_reference():
    vals = np.arange(-7, 8, dtype=np.int8)
    q = np.tile(vals, 10)[:128].reshape(4, 32)
    packed = qz.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (4, 16)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jqz.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(qz.unpack_int4(packed).numpy(), q)
    with pytest.raises(ValueError, match="even"):
        qz.pack_int4(torch.zeros(3, dtype=torch.int8))


@pytest.mark.parametrize("K,N,group", [(64, 8, 32), (128, 24, 64),
                                       (96, 5, 2)])
def test_quantize_q4_bit_equal_to_reference(K, N, group):
    rng = np.random.default_rng(21)
    w = rng.normal(size=(K, N)).astype(np.float32)
    w[5, 2] = 40.0                               # outlier stays in group 0
    ties = group >= 8                            # room for 4 ties in group 1
    if ties:
        w[group:group + 1, 0] = _one_scale_amax(qz.Q4_MAX)
        w[group + 1:group + 1 + 4, 0] = [0.5, 1.5, -2.5, 3.5]
    jp, js = jax.jit(lambda v: jqz.quantize_q4(v, group=group))(
        jnp.asarray(w))
    packed, scales = qz.quantize_q4(torch.from_numpy(w), group=group)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    # byte r = row 2r (low nibble) | row 2r+1 (high nibble), codes + 8
    codes = qz.unpack_int4(packed.t().contiguous()).t()
    if ties:
        np.testing.assert_array_equal(codes[group + 1:group + 5, 0].numpy(),
                                      [0, 2, -2, 4])
    jdeq = jax.jit(lambda a, b: jqz.dequantize_q4(a, b, group=group))(jp, js)
    np.testing.assert_array_equal(
        qz.dequantize_q4(packed, scales, group=group).numpy(),
        np.asarray(jdeq))
    # a leading (rank) dim quantizes each panel on its own
    stacked = torch.from_numpy(np.stack([w, -w]))
    sp, ss = qz.quantize_q4(stacked, group=group)
    assert torch.equal(sp[0], packed) and torch.equal(ss[0], scales)
    with pytest.raises(ValueError, match="groups"):
        qz.quantize_q4(torch.from_numpy(w), group=group + 1)


def test_stochastic_rounding_is_unbiased():
    """The noise is the port's own (a torch.Generator), so the test is
    statistical: every code is the floor or the ceiling of the scaled
    value, and the mean over draws converges on the input."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 2048)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = 400
    total = torch.zeros_like(x)
    for _ in range(draws):
        q, s, meta = qz.block_quantize(x, block=256, stochastic=True,
                                       generator=gen)
        scaled = x.reshape(1, -1, 256) / s[..., None]
        assert torch.all((q >= torch.floor(scaled))
                         & (q <= torch.ceil(scaled)))
        total += qz.block_dequantize(q, s, meta, x.shape)
    step = s.repeat_interleave(256, dim=1)
    # per element the draw is Bernoulli on one step: sd <= step / 2
    assert torch.all((total / draws - x).abs()
                     <= 5 * step / (2 * draws ** 0.5))
    with pytest.raises(ValueError, match="Generator"):
        qz.block_quantize(x, stochastic=True)


# ---------------------------------------------------------------------------
# the substrate additions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["2x4", "4x2", "2x(2x2)-pod.dp.tp"])
def test_substrate_additions_match_reference(label):
    """``pmax``; psum / psum_scatter keep an int16 payload int16 (priced at
    2 bytes); untiled gathers of u8 / u16 / i8 record their true width; the
    per-rank dynamic update slice starts at ``pod * size``."""
    jvc, tvc = PAIRS[label]
    R, slow, fast = tvc.num_devices, tvc.slow_names, tvc.fast_names
    rng = np.random.default_rng(5)
    x = rng.normal(size=(R * 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvc.run(lambda v: coll.pmax(v, tvc.axis_names), x).numpy(),
        np.asarray(_jrun(jvc, lambda v: lax.pmax(v, jvc.axis_names), x)))
    i16 = rng.integers(-127, 128, size=(R * 4, 3)).astype(np.int16)
    with tvc.bind(), coll.recording() as rec:
        s16 = coll.psum(tvc.stack(i16), fast)
        rs16 = coll.psum_scatter(tvc.stack(i16), fast)
    assert s16.dtype == rs16.dtype == torch.int16
    assert [r.out_bytes for r in rec] == [4 * 3 * 2, 4 * 3 * 2 // tvc.chips]
    np.testing.assert_array_equal(
        tvc.unstack(s16).numpy(),
        np.asarray(_jrun(jvc, lambda v: lax.psum(v, fast), i16)))
    for dt, td in ((np.uint8, torch.uint8), (np.uint16, torch.uint16),
                   (np.int8, torch.int8)):
        v = rng.integers(0, 100, size=(R * 6,)).astype(dt)
        with tvc.bind(), coll.recording() as rec:
            got = coll.all_gather(tvc.stack(v), slow, axis=0, tiled=False)
        assert got.dtype == td
        assert rec[0].out_bytes == tvc.pods * 6 * np.dtype(dt).itemsize
        want = _jrun(jvc, lambda u: lax.all_gather(u, slow, axis=0,
                                                   tiled=False)[None], v)
        np.testing.assert_array_equal(got.numpy().reshape(-1),
                                      np.asarray(want).reshape(-1))
    big = rng.normal(size=(R * tvc.pods * 4, 2)).astype(np.float32)
    small = rng.normal(size=(R * 4, 2)).astype(np.float32)

    def tbody(out, upd):
        start = coll.axis_index(slow) * upd.shape[1]
        return coll.dynamic_update_slice_in_dim(out, upd, start, axis=0)

    def jbody(out, upd):
        start = lax.axis_index(slow) * upd.shape[0]
        return lax.dynamic_update_slice_in_dim(out, upd, start, axis=0)

    np.testing.assert_array_equal(tvc.run(tbody, big, small).numpy(),
                                  np.asarray(_jrun(jvc, jbody, big, small)))


# ---------------------------------------------------------------------------
# lossy bodies through the Communicator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["q8_hier", "qbf16_hier"])
@pytest.mark.parametrize("label", LABELS)
def test_error_feedback_matches_reference(label, scheme):
    """``allreduce(error_feedback=)`` returns ``(sum, residual)``: the sum
    within the sums' tolerance, the local residual allclose."""
    jvc, tvc = PAIRS[label]
    R = tvc.num_devices
    rng = np.random.default_rng(31)
    m = 16
    x = (rng.normal(size=(R * m, 3)) * 3).astype(np.float32)
    shard = m if tvc.pods == 1 else m // tvc.chips
    e = (rng.normal(size=(R * shard, 3)) * 0.01).astype(np.float32)
    jc, tc = JComm.from_cluster(jvc), Communicator.from_cluster(tvc)
    want = _jrun(jvc, lambda v, r: jc.allreduce(
        v, scheme=scheme, precision="lossy", error_feedback=r), x, e,
        out_specs=(jvc.spec, jvc.spec))
    got = tvc.run(lambda v, r: tc.allreduce(
        v, scheme=scheme, precision="lossy", error_feedback=r), x, e)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("label", ["2x4", "4x2"])
def test_error_feedback_residual_converges(label):
    """Repeating one lossy reduction with the residual fed back averages
    the quantization error out (the reference's error-feedback test)."""
    _, vc = PAIRS[label]
    comm = Communicator.from_cluster(vc)
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(vc.num_devices, 128)) * 3).astype(np.float32)
    exact = x.sum(axis=0)
    T = 8

    def body(v):
        err, acc = 0.0, torch.zeros_like(v)
        for _ in range(T):
            out, err = comm.allreduce(v, scheme="q8_hier", precision="lossy",
                                      error_feedback=err)
            acc += out
        return acc / T

    with vc.bind():
        xs = torch.from_numpy(x)
        avg = body(xs).numpy()
        single = comm.allreduce(xs, scheme="q8_hier",
                                precision="lossy").numpy()
    avg_err = float(np.abs(avg - exact).max())
    single_err = float(np.abs(single - exact).max())
    bound, _ = registry.get_scheme("q8_hier").error_check(
        "psum", inputs=(x,), output=single, pods=vc.pods, chips=vc.chips,
        elems=128)
    assert avg_err <= bound
    assert avg_err <= max(single_err * 0.5, bound * 0.1)


@pytest.mark.parametrize("label", LABELS)
def test_exact_pick_under_lossy_absorbs_residual(label):
    _, vc = PAIRS[label]
    comm = Communicator.from_cluster(vc)
    with vc.bind():
        out, err = comm.allreduce(torch.ones(vc.num_devices, 8),
                                  scheme="hier", precision="lossy",
                                  error_feedback=0.5)
    assert err.item() == 0.0
    torch.testing.assert_close(out, torch.full_like(out, 1.5 *
                                                    vc.num_devices))


def test_lossy_opt_in_is_required_in_both_packages():
    jvc, tvc = PAIRS["2x4"]
    x = np.ones((tvc.num_devices * 16,), np.float32)
    jc, tc = JComm.from_cluster(jvc), Communicator.from_cluster(tvc)
    for scheme, method in (("q8_hier", "allreduce"),
                           ("q4_shared", "allgather")):
        with pytest.raises(ValueError, match="lossy"):
            _jrun(jvc, lambda v: getattr(jc, method)(v, scheme=scheme), x)
        with pytest.raises(ValueError, match="lossy"):
            tvc.run(lambda v: getattr(tc, method)(v, scheme=scheme), x)
    with pytest.raises(ValueError, match="lossy"):
        Communicator(fast_axis="data", pods=1, chips=4).allreduce(
            torch.ones(4), error_feedback=0.0)
    with pytest.raises(ValueError, match="precision"):
        tuning.resolve("psum", pods=2, chips=4, elems=64, precision="lossless")


@pytest.mark.parametrize("label", LABELS)
def test_lossy_auto_pick_matches_reference_model(label):
    """Under ``precision="lossy"`` (tol None / 1e-3 / 1e-2) the port's
    ``auto`` pick is the reference's modeled pick (both tables emptied), or
    both refuse the cell."""
    _, vc = PAIRS[label]
    comm = Communicator.from_cluster(vc)
    n_fast = len(vc.fast_names)
    with jtuning.use_table(None), tuning.use_table(None):
        for family in traffic.FAMILIES:
            for elems in (64, 1 << 16):
                for result in (None, "replicated", "shared"):
                    for tol in (None, 1e-3, 1e-2):
                        kw = dict(elems=elems, result_class=result,
                                  precision="lossy", tol=tol)
                        try:
                            want = jtuning.resolve(
                                family, pods=vc.pods, chips=vc.chips,
                                n_fast_axes=n_fast, **kw)
                        except ValueError:
                            with pytest.raises(ValueError):
                                tuning.resolve_for(comm, family, **kw)
                            continue
                        got = tuning.resolve_for(comm, family, **kw)
                        assert (got.scheme, got.opts, got.source) == \
                            (want.scheme, want.opts, want.source), \
                            (family, elems, result, tol)
    bare = Communicator(fast_axis="data")
    for family in traffic.FAMILIES:
        for result in (None, "replicated", "shared"):
            kw = dict(elems=8, result_class=result, precision="lossy")
            try:
                want = jtuning.resolve(family, pods=None, chips=None, **kw)
            except ValueError:
                with pytest.raises(ValueError):
                    tuning.resolve_for(bare, family, **kw)
                continue
            assert tuning.resolve_for(bare, family, **kw).scheme == \
                want.scheme


@pytest.mark.parametrize("family,name", LOSSY_CASES,
                         ids=[f"{f}-{s}" for f, s in LOSSY_CASES])
def test_lossy_closed_forms_match_reference(family, name):
    """``links(opts=, dtype=)``, ``candidates``, ``error_bound_rel`` and the
    host-side ``error_check`` of every lossy scheme equal the reference's."""
    t, j = registry.get_scheme(name), jregistry.get_scheme(name)
    rng = np.random.default_rng(3)
    for label in LABELS:
        _, vc = PAIRS[label]
        shape = dict(pods=vc.pods, chips=vc.chips)
        assert t.error_bound_rel(family, pods=vc.pods) == \
            j.error_bound_rel(family, pods=vc.pods)
        for elems in (1, 48, 1024, 1 << 20):
            kw = dict(shape, elems=elems, fast_shape=vc.fast_shape)
            for opts in (None, {"block": 64}, {"block": 256}):
                for dtype in ("float32", "bfloat16"):
                    assert t.links(family, opts=opts, dtype=dtype, **kw) == \
                        j.links(family, opts=opts, dtype=dtype, **kw)
        x = rng.normal(size=(vc.num_devices, 64)).astype(np.float32)
        out = x.sum(axis=0) if family == "psum" else x.reshape(-1)
        if name == "q4_shared":
            out = j._allgather_reference(x.reshape(-1), pods=vc.pods,
                                         chips=vc.chips, elems=64)
        out = out + np.float32(1e-3)
        inputs = (x,) if family == "psum" else (x.reshape(-1),)
        for dtype in ("float32", "bfloat16"):
            assert t.error_check(family, inputs=inputs, output=out,
                                 elems=64, dtype=dtype, **shape) == \
                j.error_check(family, inputs=inputs, output=out, elems=64,
                              dtype=dtype, **shape)


@pytest.mark.parametrize("label", LABELS)
def test_check_lossy_on_the_cpu(label):
    """Every lossy wire format on every topology: link bytes, error bound,
    exact own pod region, resident bytes (``q4_shared``: one copy/node)."""
    _, vc = PAIRS[label]
    rows = traffic.check_lossy(vc, elems=512)
    assert {(r.family, r.scheme) for r in rows} == set(LOSSY_CASES)
    for r in rows:
        if r.family == "allgather":
            assert r.own_region_exact
        if r.scheme == "q4_shared":
            assert r.node_bytes == vc.num_devices * 512 * 4
        if vc.pods > 1 and (r.scheme, r.family) != ("qbf16_hier", "psum"):
            assert r.slow_bytes < r.parent_slow


# ---------------------------------------------------------------------------
# ag_matmul(precision="lossy") and the q4 kernel's plain path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("label", ["1x8", "2x4", "2x(2x2)-pod.dp.tp"])
def test_ag_matmul_lossy_matches_reference(label, nc, use_kernel):
    jvc, tvc = PAIRS[label]
    rng = np.random.default_rng(23)
    K = tvc.chips * nc * 32
    w = rng.normal(size=(K, 16)).astype(np.float32)
    x = rng.normal(size=(3, K)).astype(np.float32)
    jnode = JComm.from_cluster(jvc).split_type_shared()
    tnode = Communicator.from_cluster(tvc).split_type_shared()
    want = _jrun(jvc, lambda w_sh: jnode.ag_matmul(
        jnp.asarray(x), w_sh, n_chunks=nc, precision="lossy",
        q4_group=32)[None], _tile_rows(w, tvc))
    xs = torch.from_numpy(x).expand(tvc.num_devices, *x.shape)
    got = tvc.run(lambda w_sh: tnode.ag_matmul(
        xs, w_sh, n_chunks=nc, use_kernel=use_kernel, precision="lossy",
        q4_group=32), _tile_rows(w, tvc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        got.shape), rtol=1e-5, atol=1e-5)
    # the host-side quantize -> dequantize product (deterministic rounding)
    packed, scales = qz.quantize_q4(torch.from_numpy(w), group=32)
    host = torch.from_numpy(x) @ qz.dequantize_q4(packed, scales, group=32)
    torch.testing.assert_close(got.reshape(tvc.num_devices, 3, 16)[0], host,
                               rtol=1e-5, atol=1e-5)


def test_ag_matmul_lossy_matches_reference_pallas_kernel():
    """The reference's own kernel path (Pallas, interpret mode) too."""
    jvc, tvc = PAIRS["2x4"]
    rng = np.random.default_rng(24)
    K = tvc.chips * 64
    w = rng.normal(size=(K, 16)).astype(np.float32)
    x = rng.normal(size=(4, K)).astype(np.float32)
    jnode = JComm.from_cluster(jvc).split_type_shared()
    tnode = Communicator.from_cluster(tvc).split_type_shared()
    want = _jrun(jvc, lambda w_sh: jnode.ag_matmul(
        jnp.asarray(x), w_sh, n_chunks=2, precision="lossy", q4_group=32,
        use_kernel=True)[None], _tile_rows(w, tvc))
    xs = torch.from_numpy(x).expand(tvc.num_devices, *x.shape)
    got = tvc.run(lambda w_sh: tnode.ag_matmul(
        xs, w_sh, n_chunks=2, use_kernel=True, precision="lossy",
        q4_group=32), _tile_rows(w, tvc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        got.shape), rtol=1e-5, atol=1e-5)


def test_ag_matmul_lossy_rejects_bad_chunking():
    _, vc = PAIRS["1x8"]
    node = Communicator.from_cluster(vc).split_type_shared()
    with vc.bind():
        w = torch.zeros(8, 48, 4)
        with pytest.raises(ValueError, match="group"):
            node.ag_matmul(torch.zeros(8, 2, 384), w, precision="lossy")
        with pytest.raises(ValueError, match="precision"):
            node.ag_matmul(torch.zeros(8, 2, 384), w, precision="q4")


@pytest.mark.parametrize("M,K,N,dtype", [(4, 64, 16, "float32"),
                                         (5, 96, 20, "float32"),
                                         (4, 64, 16, "bfloat16"),
                                         (5, 96, 20, "bfloat16")])
def test_ops_q4_matmul_matches_pallas_interpret(M, K, N, dtype):
    rng = np.random.default_rng(17)
    a = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    jp, js = jax.jit(lambda v: jqz.quantize_q4(v, group=32))(jnp.asarray(w))
    want = jops.q4_matmul(jnp.asarray(a).astype(jd), jp, js, group=32,
                          interpret=True)
    packed, scales = qz.quantize_q4(torch.from_numpy(w), group=32)
    got = ops.q4_matmul(torch.from_numpy(a).to(td), packed, scales, group=32)
    assert got.shape == (M, N) and got.dtype == td
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2 * 8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol)


def test_ops_q4_matmul_batched_is_per_rank_product():
    rng = np.random.default_rng(18)
    a = torch.from_numpy(rng.normal(size=(3, 7, 64)).astype(np.float32))
    packed, scales = qz.quantize_q4(
        torch.from_numpy(rng.normal(size=(3, 64, 9)).astype(np.float32)))
    got = ops.q4_matmul(a, packed, scales)
    for r in range(3):
        torch.testing.assert_close(
            got[r], a[r] @ qz.dequantize_q4(packed[r], scales[r]))


@pytest.mark.parametrize("a_shape,p_shape,s_shape,group,err", [
    ((4, 64), (32, 8), (2, 8), 24, ValueError),          # group vs K
    ((4, 64), (30, 8), (2, 8), 32, ValueError),          # packed rows
    ((4, 64), (32, 8), (4, 8), 32, ValueError),          # scale rows
    ((2, 4, 64), (3, 32, 8), (3, 2, 8), 32, ValueError),  # batch
    ((4, 64), (32, 8), (2, 8), 3, ValueError),           # odd group
])
def test_ops_q4_matmul_rejects_bad_operands(a_shape, p_shape, s_shape,
                                            group, err):
    with pytest.raises(err):
        ops.q4_matmul(torch.zeros(a_shape), torch.zeros(p_shape,
                                                        dtype=torch.uint8),
                      torch.zeros(s_shape), group=group)
    with pytest.raises(TypeError):
        ops.q4_matmul(torch.zeros(4, 64, dtype=torch.float64),
                      torch.zeros(32, 8, dtype=torch.uint8),
                      torch.zeros(2, 8))


def test_q4_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors or raises — it never falls back
    to the plain version."""
    packed, scales = qz.quantize_q4(torch.ones(64, 8))
    before = kquant.launches
    with pytest.raises(ValueError, match="CUDA"):
        kquant.q4_matmul_cuda(torch.ones(4, 64), packed, scales, 32)
    assert kquant.launches == before


def test_every_kernel_builds_through_one_builder(monkeypatch):
    """Every kernel module binds its entry points on the library the one
    builder returns for its own source."""
    from repro_torch.kernels import flash_attention_bwd as kflash_bwd
    from repro_torch.kernels import lru_scan_bwd as klru_bwd
    from repro_torch.kernels import moe_gather as kmoe
    asked = []
    mods = (kmatmul, kquant, kflash, kflash_bwd, klru, klru_bwd, kmoe)

    def fake(source):
        asked.append(source)
        names = [n for mod in mods for n in mod._ENTRY.values()]
        cdll = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                        for n in names})
        return _cuda.Library(cdll, _cuda.BUILD_DIR / source, 0.0, "")

    monkeypatch.setattr(_cuda, "library", fake)
    for mod in mods:
        mod.library.cache_clear()
    try:
        libs = [mod.library() for mod in mods]
    finally:
        for mod in mods:
            mod.library.cache_clear()
    assert asked == ["matmul.cu", "q4_matmul.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu", "lru_scan.cu",
                     "lru_scan_bwd.cu", "moe_gather.cu"]
    assert set(asked) == set(_cuda.SOURCES)
    for lib, mod in zip(libs, mods):
        for name in mod._ENTRY.values():
            assert getattr(lib.cdll, name).restype is not None
