"""The port on a CUDA card: the Hopper kernels and the stream-ordered paths.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports nothing of JAX, so it also runs on a machine that has only
PyTorch (the suite's conftest imports the JAX package, hence
``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

The kernels are held against their plain versions with the reference
kernel tests' tolerances (F32 2e-4 / BF16 2e-2, rtol K-scaled, atol x8).
On infinite, NaN and near-max operands the matmul, q4 and flash kernels
equal their plain versions class by class (the non-finite rule of
``csrc/tf32x3.cuh``), their recompute counters count the tiles that took
the rule, and finite operands recompute nothing.
The card's collectives and fused collective-matmuls (side stream + events)
are held against the same code run on the CPU: gathers bit for bit,
products and sums within 1e-5.  The lossy wire formats are held to
``traffic.check_lossy`` on the card.  The flash-attention kernel is held
to its plain version (F32 2e-4 / BF16 2e-2), and a full-width
``qwen3-0.6b`` unit's prefill on the card (the kernel) to the same prefill
on the CPU (the plain version) within 1e-4 relative.  The lru_scan kernel
is held to its plain version (f32 2e-4, bf16 5e-2; ragged C and T, B 1 and
8, the a = 1 carry against ``cumsum``), and a full-width
``recurrentgemma-9b`` ``rglru`` block's prefill on the card to the CPU.
The flash backward kernel is held to the autograd of the plain version
(f32 2e-4, bf16 2e-2 of the largest gradient), its forward with lse to the
forward without it bit for bit, and the reduced ``qwen3-0.6b``'s hier
train step on the card to the CPU.  The panel kernel's three layouts (NN,
and the gradients' NT and TN) are held to the plain version and to a
float64 product at the training step's shapes, ``ops.matmul``'s gradients
to autograd's f32 product, and ``ParallelCtx.mm`` takes the kernel only
for float32 products with a full 128-row tile and one 128 x 128 output
tile a SM; ``q4_matmul``, which has no backward, refuses a grad-carrying
call.  The lru_scan backward kernel is
held to its plain version through ``ops.lru_scan``'s autograd, and the
reduced ``recurrentgemma-9b``'s hier train step on the card to the CPU.  Serving on the stacked cluster (``serve_fsdp``, 2x4
and ``2x(2x2)``, the reduced qwen3-0.6b and the hybrid at tp 2): prefill
and two decode steps on the card against the CPU within 1e-4 relative, and
``RecordedDecoder`` bit-identical to the sync decode on the card.  The
xLSTM family (no hand-written kernel): ``xlstm-1.3b``'s full-width mLSTM
and sLSTM blocks (forward, gradients, decode) and the reduced model's
hier train step and cluster serving on 2x4 and ``2x(2x2)``, card against
CPU.  The MoE row movements (``csrc/moe_gather.cu``) equal their plain
versions bit for bit at granite's width and on the capacity path's
batched tables (the gates' gradient within 1e-6 of float64), run to run,
and launch 32 / 32 / 16 / 16 times in a granite step.  The port's spans (``core.spans``) stay off the device timeline and
time their work with CUDA event pairs.
"""

import dataclasses

import pytest
import torch

from repro_torch.analysis import traffic
from repro_torch.comm import Communicator
from repro_torch.comm.quantize import dequantize_q4, quantize_q4
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import lru_scan as klru
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import moe_gather as kmoe
from repro_torch.kernels import ops
from repro_torch.kernels import quant as kquant
from repro_torch.models import ParallelCtx, build
from repro_torch.substrate import VirtualCluster, default_matrix

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, K):
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    return dict(rtol=tol * max(1, K // 256 + 1), atol=tol * 8)


@pytest.mark.parametrize("shape", [(96, 160, 224), (256, 512, 384),
                                   (1024, 1024, 1024), (1, 1, 1),
                                   (3, 129, 131, 7),
                                   # the 128 x 128 x 32 tiling's edges: K <
                                   # 32, K = 4100, N = 4 and 20, and rows
                                   # not 16-byte aligned, batch 3
                                   (64, 20, 4), (33, 4100, 20),
                                   (3, 70, 33, 21), (200, 17, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", kmatmul.LAYOUTS)
def test_kernel_matches_plain_version(cuda, shape, dtype, layout):
    """Every layout, each operand row-major as given: nn through
    ``ops.matmul``, nt and tn through the wrapper."""
    *batch, M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    a, b = _layout_operands(g, cuda, layout, batch, M, N, K, dtype)
    before = kmatmul.launches, kmatmul.launches_by_layout[layout]
    got = ops.matmul(a, b) if layout == "nn" else \
        kmatmul.matmul_cuda(a, b, layout)
    torch.cuda.synchronize()
    assert (kmatmul.launches, kmatmul.launches_by_layout[layout]) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (*batch, M, N) and got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               kmatmul.matmul_plain(a, b, layout).float(),
                               **_tol(dtype, K))


def _layout_operands(g, device, layout, batch, M, N, K, dtype):
    """Random operands of ``op(a) @ op(b)`` (M, K) @ (K, N) as the layout
    gives them: a (K, M) for tn, b (N, K) for nt."""
    sa = (K, M) if layout == "tn" else (M, K)
    sb = (N, K) if layout == "nt" else (K, N)
    return (torch.randn((*batch, *sa), generator=g, device=device).to(dtype),
            torch.randn((*batch, *sb), generator=g, device=device).to(dtype))


def _f64(a, b, layout):
    return (a.double().transpose(-1, -2) if layout == "tn" else a.double()) \
        @ (b.double().transpose(-1, -2) if layout == "nt" else b.double())


@pytest.mark.parametrize("layout,shape", [
    # the qwen3-0.6b step's products and gradients (4 ranks' rows folded:
    # wq's forward and dX, w_out's dW; the unembedding chunk's dX and dW)
    ("nn", (8192, 1024, 2048)), ("nt", (8192, 2048, 1024)),
    ("tn", (3072, 8192, 1024)), ("nt", (2048, 151936, 1024)),
    ("tn", (1024, 2048, 151936)),
    # ragged and unaligned edges
    ("nt", (129, 4100, 130)), ("tn", (129, 4100, 130)),
    ("nt", (3, 70, 33, 21)), ("tn", (3, 70, 33, 21)),
    ("nt", (33, 131, 21)), ("tn", (33, 131, 21))])
def test_kernel_layouts_against_float64(cuda, layout, shape):
    """(M, K, N): the kernel's largest error over the float64 product's
    largest |C| is at most twice ``torch.matmul``'s f32 one, or 2e-6 at K
    1024 grown as sqrt(K): the kernel adds its K / 32 tile sums in order,
    an fp32 sum whose error walks as sqrt(K), where cuBLAS may split a
    deep K (the unembedding's dX, K 151,936)."""
    *batch, M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(9)
    a, b = _layout_operands(g, cuda, layout, batch, M, N, K, torch.float32)
    want = _f64(a, b, layout)
    top = want.abs().max()
    err = ((kmatmul.matmul_cuda(a, b, layout).double() - want).abs().max()
           / top).item()
    lib = torch.matmul(a.transpose(-1, -2) if layout == "tn" else a,
                       b.transpose(-1, -2) if layout == "nt" else b)
    lib_err = ((lib.double() - want).abs().max() / top).item()
    assert err <= max(2 * lib_err, 2e-6 * (K / 1024) ** 0.5), (err, lib_err)


F32_MAX = torch.finfo(torch.float32).max         # 3.4028235e38
NONFINITE = [float("inf"), float("-inf"), float("nan"), F32_MAX, -3.4e38]


def _same_classes(got, want, bound, tol):
    """``got`` is non-finite exactly where ``want`` is, with its class; the
    finite values within ``tol * (1 + bound)``."""
    g, w = got.float(), want.float()
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(g), kind(w)), kind.__name__
    fin = torch.isfinite(w)
    assert ((g - w).abs() <= tol * (1 + bound))[fin].all()


@pytest.mark.parametrize("value", NONFINITE, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", kmatmul.LAYOUTS)
def test_kernel_follows_ieee_on_nonfinite_operands(cuda, value, dtype,
                                                   layout):
    """One special entry in ``a`` (batch 0) and one in ``b`` (batch 1), and
    a column of exact 1.0 in op(``b``), in every layout: the kernel equals
    ``matmul_plain`` by class and, where finite, within 2e-4 (bf16 2e-2) of
    |a| @ |b|; the tiles it touched were recomputed.  Finite operands
    recompute none."""
    g = torch.Generator(device=cuda).manual_seed(12)
    a, b = _layout_operands(g, cuda, layout, (2,), 200, 300, 96,
                            torch.float32)
    if layout == "nt":
        b[..., 0, :] = 1.0
    else:
        b[..., 0] = 1.0
    kmatmul.recomputes.reset()
    kmatmul.matmul_cuda(a.to(dtype), b.to(dtype), layout)
    assert kmatmul.recomputes.read() == 0
    a[0, 3, 5], b[1, 7, 2] = value, value
    a, b = a.to(dtype), b.to(dtype)
    got = kmatmul.matmul_cuda(a, b, layout)
    assert kmatmul.recomputes.read() > 0
    _same_classes(got, kmatmul.matmul_plain(a, b, layout),
                  _f64(a.abs(), b.abs(), layout),
                  2e-4 if dtype == torch.float32 else 2e-2)


def test_kernel_wrapper_checks_its_operands(cuda):
    a = torch.ones(64, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kmatmul.matmul_cuda(a, torch.ones(64, 32, device=cuda).t())
    with pytest.raises(ValueError, match="CUDA"):
        kmatmul.matmul_cuda(a, torch.ones(32, 8))
    with pytest.raises(TypeError):
        kmatmul.matmul_cuda(a.half(), torch.ones(32, 8, device=cuda).half())
    # ops.matmul makes a strided operand contiguous for the kernel
    bt = torch.ones(8, 32, device=cuda).t()
    torch.testing.assert_close(ops.matmul(a, bt), a @ bt)


def _both(vc_kw, body, *inputs):
    """Run ``body`` on the CPU and on the card; return both results."""
    out = []
    for dev in ("cpu", "cuda"):
        vc = VirtualCluster(**vc_kw, device=dev)
        out.append(vc.run(body(Communicator.from_cluster(vc)),
                          *[x.to(dev) for x in inputs]))
    return out[0], out[1].cpu()


@pytest.mark.parametrize("nc", [1, 2, 3, 4])
def test_fused_collective_matmuls_on_the_card(cuda, nc):
    """ag_matmul / ag_matmul_rows / matmul_rs run their collectives on a
    side stream (with the two-buffer events from the third chunk on) and
    agree with the same calls on the CPU."""
    kw = dict(pods=2, chips=4)
    R, c = 8, 4
    g = torch.Generator().manual_seed(nc)
    w_sh = torch.randn((R * 12 * nc, 40), generator=g)
    x = torch.randn((R * 5, c * 12 * nc), generator=g)
    a_sh = torch.randn((R * 8 * nc, 24), generator=g)
    b = torch.randn((R * 24, 40), generator=g)
    xs = torch.randn((R * c * 4 * nc, 24), generator=g)
    ws = torch.randn((R * 24, 40), generator=g)

    def ag(comm):
        node = comm.split_type_shared()
        return lambda w, xx: node.ag_matmul(xx, w, n_chunks=nc,
                                            use_kernel=xx.is_cuda)

    def rows(comm):
        node = comm.split_type_shared()
        return lambda a, bb: node.ag_matmul_rows(a, bb, n_chunks=nc,
                                                 use_kernel=a.is_cuda)

    def rs(comm):
        node = comm.split_type_shared()
        return lambda xx, w: node.matmul_rs(xx, w, n_chunks=nc,
                                            use_kernel=xx.is_cuda)

    for body, inputs in ((ag, (w_sh, x)), (rows, (a_sh, b)), (rs, (xs, ws))):
        want, got = _both(kw, body, *inputs)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vc", default_matrix(device="cuda"),
                         ids=lambda vc: vc.label)
def test_evidence_matrix_on_the_card(cuda, vc):
    """Values, recorded traffic and C1 as device bytes
    (``torch.cuda.memory_allocated``) on every topology."""
    rows = traffic.check_matrix(vc, elems=4096)
    ratios = traffic.c1_ratios(rows)
    for fam in ("allgather", "broadcast", "psum"):
        assert ratios[(vc.label, fam)] == vc.chips


@pytest.mark.parametrize("scheme", ["naive", "hier", "shared", "pipelined"])
def test_collectives_on_the_card_equal_the_cpu(cuda, scheme):
    x = torch.randn((8 * 64, 3), generator=torch.Generator().manual_seed(1))
    for fam in ("allgather", "psum"):
        def body(comm, fam=fam):
            method = comm.allgather if fam == "allgather" else comm.allreduce

            def run(v):
                out = method(v, scheme=scheme)
                return out.shard if hasattr(out, "shard") else out
            return run
        want, got = _both(dict(pods=2, chips=4), body, x)
        if fam == "allgather":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the q4 kernel and the lossy path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64, 16, 32), (5, 96, 20, 32),
                                   (130, 256, 300, 64), (1, 6, 3, 2),
                                   (3, 33, 192, 129, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q4_kernel_matches_plain_version(cuda, shape, dtype):
    *batch, M, K, N, group = shape
    g = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn((*batch, M, K), generator=g, device=cuda).to(dtype)
    w = torch.randn((*batch, K, N), generator=g, device=cuda)
    packed, scales = quantize_q4(w, group=group)
    before = kquant.launches
    got = ops.q4_matmul(a, packed, scales, group=group)
    torch.cuda.synchronize()
    assert kquant.launches == before + 1
    assert got.shape == (*batch, M, N) and got.dtype == dtype
    torch.testing.assert_close(
        got.float(), kquant.q4_matmul_plain(a, packed, scales, group).float(),
        **_tol(dtype, K))


def test_q4_kernel_equals_panel_kernel_on_the_dense_weight(cuda):
    """The fused unpack gives the panel-matmul kernel's result on the
    dequantized weight bit for bit.  The two kernels sum in different
    orders (fp32 FMA against 3xTF32 on the tensor cores), so the operands
    make every product and partial sum exact in f32 and in TF32: small
    integers for ``a``, every int4 code, power-of-two scales.  Both kernels
    then give the exact product."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randint(-8, 9, (2, 200, 320), generator=g, device=cuda).float()
    packed = torch.randint(0, 256, (2, 160, 144), generator=g, device=cuda,
                           dtype=torch.uint8)
    scales = torch.ldexp(torch.ones((2, 10, 144), device=cuda), torch.randint(
        -3, 4, (2, 10, 144), generator=g, device=cuda))
    w = dequantize_q4(packed, scales, group=32)
    got = ops.q4_matmul(a, packed, scales, group=32)
    assert torch.equal(got, ops.matmul(a, w))
    assert torch.equal(got, (a.double() @ w.double()).float())


@pytest.mark.parametrize("value", NONFINITE, ids=str)
def test_q4_kernel_follows_ieee_on_nonfinite_operands(cuda, value):
    """A special entry in ``a`` (batch 0) and in a scale (batch 1): the q4
    kernel equals its plain version by class and, where finite, within
    2e-4 of |a| @ |w|; finite operands recompute nothing."""
    g = torch.Generator(device=cuda).manual_seed(13)
    a = torch.randn((2, 160, 128), generator=g, device=cuda)
    packed, scales = quantize_q4(torch.randn((2, 128, 200), generator=g,
                                             device=cuda), group=32)
    kquant.recomputes.reset()
    ops.q4_matmul(a, packed, scales, group=32)
    assert kquant.recomputes.read() == 0
    a[0, 3, 5], scales[1, 2, 7] = value, value
    got = ops.q4_matmul(a, packed, scales, group=32)
    assert kquant.recomputes.read() > 0
    w = dequantize_q4(packed, scales, group=32)
    _same_classes(got, kquant.q4_matmul_plain(a, packed, scales, 32),
                  a.double().abs() @ w.double().abs(), 2e-4)


def test_q4_kernel_wrapper_checks_its_operands(cuda):
    a = torch.ones(4, 64, device=cuda)
    packed, scales = quantize_q4(torch.ones(64, 8, device=cuda), group=32)
    with pytest.raises(ValueError, match="contiguous"):
        kquant.q4_matmul_cuda(a, packed.t().contiguous().t(), scales, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kquant.q4_matmul_cuda(a, packed.cpu(), scales, 32)
    with pytest.raises(ValueError, match="groups"):
        kquant.q4_matmul_cuda(a, packed, scales, 24)
    with pytest.raises(TypeError):
        kquant.q4_matmul_cuda(a.half(), packed, scales, 32)


@pytest.mark.parametrize("nc,use_kernel", [(1, True), (2, True), (3, True),
                                           (2, False)])
def test_lossy_ag_matmul_on_the_card_equals_the_cpu(cuda, nc, use_kernel):
    """``ag_matmul_q4`` on the card (side-stream quantize + gather, the q4
    kernel) equals the same call on the CPU (the plain version)."""
    kw = dict(pods=2, chips=4)
    R, c = 8, 4
    g = torch.Generator().manual_seed(nc)
    w_sh = torch.randn((R * 32 * nc, 40), generator=g)
    x = torch.randn((R * 5, c * 32 * nc), generator=g)

    def body(comm):
        node = comm.split_type_shared()
        return lambda w, xx: node.ag_matmul(
            xx, w, n_chunks=nc, use_kernel=use_kernel and xx.is_cuda,
            precision="lossy", q4_group=32)

    want, got = _both(kw, body, w_sh, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vc", default_matrix(device="cuda"),
                         ids=lambda vc: vc.label)
def test_lossy_evidence_on_the_card(cuda, vc):
    """Link bytes, error bound, exact own pod region and resident bytes of
    every lossy wire format, as device work."""
    rows = traffic.check_lossy(vc, elems=4096)
    assert rows
    assert all(r.error <= r.bound for r in rows)


# ---------------------------------------------------------------------------
# the flash-attention kernel and the model's prefill
# ---------------------------------------------------------------------------

FLASH_CASES = [(1, 4, 4, 128, 128, 64, True, None),    # tests/test_kernels.py
               (2, 8, 2, 128, 128, 64, True, None),
               (1, 4, 1, 64, 256, 32, True, None),
               (1, 3, 3, 96, 96, 16, True, None),
               (2, 4, 2, 256, 256, 64, True, None),
               (1, 2, 2, 128, 128, 32, True, 16),      # windows
               (1, 2, 2, 128, 128, 32, True, 64),
               (1, 2, 2, 64, 64, 32, False, None),     # non-causal
               (1, 8, 1, 200, 200, 256, True, None),   # hd 256, ragged
               (2, 16, 8, 300, 300, 128, True, None),  # the model's heads
               # the tiling's edges: Tq not a multiple of the 64-row q
               # tile, Tkv = 1, window 1, a window at hd 256
               (1, 2, 1, 100, 100, 128, True, 1),
               (1, 2, 2, 1, 1, 64, True, None),
               (1, 4, 2, 70, 70, 256, True, 5),
               (2, 2, 1, 77, 300, 128, False, None),
               # granite-moe-3b-a800m's heads: 24 q / 8 kv at hd 64
               (2, 24, 8, 200, 200, 64, True, None)]


def _flash_tol(dtype):
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    return dict(rtol=tol, atol=tol)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, case, dtype):
    B, H, KV, Tq, Tkv, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((B, H, Tq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, KV, Tkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, KV, Tkv, hd), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=Tkv - Tq)
    before = kflash.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kflash.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    torch.testing.assert_close(
        got.float(), kflash.flash_attention_plain(q, k, v, **kw).float(),
        **_flash_tol(dtype))


@pytest.mark.parametrize("case", [(1, 4, 2, 128, 64, None),
                                  (1, 8, 1, 200, 256, 16)], ids=str)
def test_flash_kernel_follows_the_plain_version_on_nonfinite_entries(cuda,
                                                                     case):
    """q and k with one infinite and one near-max entry each, then v too:
    the kernel equals its plain version by class and, where finite, within
    2e-4 of 1 + the largest finite |v| of the column.  q and k send only the
    tiles they touch to the exact loop; an infinite v reaches every row in
    the plain version (0 * inf through the masked keys), so every tile."""
    B, H, KV, T, hd, window = case
    g = torch.Generator(device=cuda).manual_seed(14)
    q = torch.randn((B, H, T, hd), generator=g, device=cuda)
    k = torch.randn((B, KV, T, hd), generator=g, device=cuda)
    v = torch.randn((B, KV, T, hd), generator=g, device=cuda)
    kflash.recomputes.reset()
    ops.flash_attention(q, k, v, window=window)
    assert kflash.recomputes.read() == 0
    q[0, 1, 10, 3], q[0, 2, 70, 5] = float("inf"), F32_MAX
    k[0, 0, 20, 7], k[0, KV - 1, 40, 9] = float("-inf"), F32_MAX
    tiles = -(-T // 64) * B * H
    for v_too in (False, True):
        if v_too:
            v[0, KV - 1, 50, 11], v[0, 0, 30, 12] = float("inf"), F32_MAX
        kflash.recomputes.reset()
        got = ops.flash_attention(q, k, v, window=window)
        n = kflash.recomputes.read()
        assert n == tiles if v_too else 0 < n <= tiles
        vmax = torch.where(torch.isfinite(v), v.abs(), 0).amax(2, True)
        _same_classes(got, kflash.flash_attention_plain(q, k, v,
                                                        window=window),
                      vmax.repeat_interleave(H // KV, 1), 2e-4)


def test_flash_kernel_reads_the_models_strided_layout(cuda):
    """(B, T, heads, hd) views straight out of the fused kv projection are
    read in place and give the (B, H, T, hd) result transposed."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((2, 333, 16, 128), generator=g, device=cuda)
    kv = torch.randn((2, 333, 2, 8, 128), generator=g, device=cuda)
    k, v = kv[:, :, 0], kv[:, :, 1]
    assert kflash.kernel_ready(v) and not v.is_contiguous()
    got = kflash.flash_attention_cuda(q, k, v, layout="bthd", window=100)
    want = ops.flash_attention(*(x.transpose(1, 2).contiguous()
                                 for x in (q, k, v)), window=100)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=0)


def test_flash_kernel_wrapper_checks_its_operands(cuda):
    q = torch.ones(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        kflash.flash_attention_cuda(q[..., 1:33], q[..., :32], q[..., :32])
    with pytest.raises(ValueError, match="head_dim"):
        kflash.flash_attention_cuda(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention_cuda(q, q.cpu(), q)
    # ops.flash_attention copies an unaligned operand for the kernel
    got = ops.flash_attention(q[..., 1:33], q[..., :32], q[..., :32])
    torch.testing.assert_close(got, torch.ones(1, 2, 8, 32, device=cuda))


def test_full_width_unit_prefill_on_the_card_matches_the_cpu(cuda):
    """One unit of qwen3-0.6b at its published widths: a 512-token
    prefill through the kernel equals the plain version on the CPU."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=1)
    ctx = ParallelCtx.single()
    on_card = build(cfg, ctx, device=cuda)
    params = on_card.init_params(3)
    toks = torch.randint(0, cfg.vocab, (2, 513),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    before = kflash.launches
    cache_g, logits_g = on_card.prefill_fn(params, {"tokens": toks}, 600)
    assert kflash.launches == before + 1
    cache_c, logits_c = build(cfg, ctx, device="cpu").prefill_fn(
        _to_cpu(params), {"tokens": toks}, 600)
    scale = logits_c.abs().max()
    assert ((logits_g.cpu() - logits_c).abs().max() / scale).item() <= 1e-4
    for n in ("k", "v"):
        a, b = cache_g["units"]["b0"][n].cpu(), cache_c["units"]["b0"][n]
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-4


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


LRU_CASES = [(1, 256, 128), (2, 512, 64), (1, 100, 48),   # test_kernels.py
             (8, 64, 4096), (1, 333, 4096), (3, 7, 5)]   # B 8 / 1, ragged


@pytest.mark.parametrize("shape", LRU_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_kernel_matches_plain_version(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(10)
    a = (torch.rand(shape, generator=g, device=cuda) * 0.499 + 0.5).to(dtype)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = klru.launches
    got = ops.lru_scan(a, x)
    torch.cuda.synchronize()
    assert klru.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(),
                               klru.lru_scan_plain(a, x).float(),
                               rtol=tol, atol=tol)


def test_lru_scan_kernel_carries_like_cumsum(cuda):
    x = torch.ones((2, 1000, 96), device=cuda)
    got = ops.lru_scan(torch.ones_like(x), x)
    torch.testing.assert_close(got, x.cumsum(1), rtol=0, atol=0)


def test_lru_scan_kernel_wrapper_checks_its_operands(cuda):
    a = torch.ones((1, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        klru.lru_scan_cuda(a.half(), a.half())
    with pytest.raises(ValueError, match="contiguous"):
        klru.lru_scan_cuda(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        klru.lru_scan_cuda(a, a.cpu())
    # ops.lru_scan makes a strided operand contiguous for the kernel
    got = ops.lru_scan(a.transpose(1, 2), a.transpose(1, 2))
    torch.testing.assert_close(got, a.transpose(1, 2).cumsum(1))


def test_full_width_rglru_block_prefill_on_the_card_matches_the_cpu(cuda):
    """One rglru block of recurrentgemma-9b at its published widths: a
    300-token prefill through the scan kernel equals the plain version on
    the CPU, output and state."""
    from repro_torch.models import meta, rglru
    cfg = get_config("recurrentgemma-9b")
    ctx = ParallelCtx.single()
    defs = meta.rglru_defs(cfg, 1)
    g = torch.Generator(device=cuda).manual_seed(11)
    p = meta.map_defs(lambda _, m: meta.init_leaf(
        m, cfg.n_layers, None, generator=g, device=cuda), defs)
    x = torch.randn((2, 300, cfg.d_model), generator=g, device=cuda)
    before = klru.launches
    y_g, st_g = rglru.rglru_block(x, p, defs, ctx, cfg, return_state=True)
    torch.cuda.synchronize()
    assert klru.launches == before + 1
    y_c, st_c = rglru.rglru_block(x.cpu(), _to_cpu(p), defs, ctx, cfg,
                                  return_state=True)
    for a, b in ((y_g, y_c), (st_g["h"], st_c["h"]),
                 (st_g["conv"], st_c["conv"])):
        assert ((a.cpu() - b).abs().max() / b.abs().max()).item() <= 1e-4


# ---------------------------------------------------------------------------
# the flash backward kernel and the cluster train step on the card
# ---------------------------------------------------------------------------

BWD_CASES = [(2, 4, 2, 100, 100, 16, True, None, 0, "bhtd"),
             (1, 4, 1, 70, 90, 32, True, 16, 0, "bhtd"),
             (1, 2, 1, 40, 40, 128, True, None, -10, "bhtd"),
             (1, 2, 1, 40, 60, 128, False, None, 0, "bthd"),
             (1, 4, 2, 130, 130, 256, True, 64, 0, "bthd"),
             # a tile boundary at hd 256 and one kv head: the dk / dv pass
             # splits the group's q heads over CTAs
             (1, 8, 1, 130, 130, 256, True, 64, 0, "bhtd"),
             (2, 16, 1, 200, 260, 128, True, None, 60, "bthd"),
             # granite-moe-3b-a800m's heads: hd 64, 3 q heads a kv head
             (2, 24, 8, 130, 130, 64, True, None, 0, "bthd")]


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain_autograd(cuda, case, dtype):
    from repro_torch.kernels import flash_attention_bwd as kbwd
    B, H, KV, Tq, Tkv, hd, causal, window, qo, layout = case
    g = torch.Generator(device=cuda).manual_seed(13)
    shp = (lambda n, T: (B, n, T, hd)) if layout == "bhtd" else (
        lambda n, T: (B, T, n, hd))
    q, do = (torch.randn(shp(H, Tq), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(shp(KV, Tkv), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=qo, layout=layout)
    o_plain = kflash.flash_attention_cuda(q, k, v, **kw)
    o, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, o_plain)
    before = kbwd.launches
    got = kbwd.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert kbwd.launches == before + 1
    want = kbwd.flash_attention_bwd_plain(q, k, v, do, **kw)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err.item() <= tol


@pytest.mark.parametrize("shape", [(2, 16, 8, 512, 128, None),
                                   (2, 16, 1, 700, 256, 256)])
def test_flash_bwd_kernel_is_deterministic(cuda, shape):
    """Two launches on the same inputs give the same bits, with the heads
    split over CTAs (one kv head) or not."""
    from repro_torch.kernels import flash_attention_bwd as kbwd
    B, H, KV, T, hd, window = shape
    g = torch.Generator(device=cuda).manual_seed(15)
    q, do = (torch.randn((B, T, H, hd), generator=g, device=cuda)
             for _ in range(2))
    k, v = (torch.randn((B, T, KV, hd), generator=g, device=cuda)
            for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=0, layout="bthd")
    o, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    first = kbwd.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    second = kbwd.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bwd_overflow_takes_the_exact_path(cuda):
    """Finite operands whose dk overflows: the fast path's non-finite
    gradients are counted and recomputed on the exact path, whose classes
    are the plain autograd's."""
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import ref
    q, k, v, do = ref.bwd_overflow_inputs(
        torch.Generator(device=cuda).manual_seed(7), cuda)
    o, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True)
    kbwd.recomputes.reset()
    got = kbwd.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    assert kbwd.recomputes.read() > 0
    kbwd.recomputes.reset()
    want = kbwd.flash_attention_bwd_plain(q, k, v, do)
    for a, b in zip(got, want):
        for cls in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(cls(a), cls(b))


def test_flash_autograd_route_and_refusals(cuda):
    from repro_torch.kernels import flash_attention_bwd as kbwd
    g = torch.Generator(device=cuda).manual_seed(14)
    q = torch.randn((2, 64, 4, 64), generator=g, device=cuda,
                    requires_grad=True)
    k, v = (torch.randn((2, 64, 2, 64), generator=g, device=cuda,
                        requires_grad=True) for _ in range(2))
    before = kbwd.launches
    out = ops.flash_attention(q, k, v, layout="bthd")
    out.square().sum().backward()
    assert kbwd.launches == before + 1
    want = kbwd.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), 2 * out.detach(), layout="bthd")
    for x, w in zip((q, k, v), want):
        assert ((x.grad - w).abs().max() / w.abs().max()).item() <= 2e-4
    x = torch.ones((8, 8), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.q4_matmul(x, *quantize_q4(torch.ones((8, 8), device=cuda),
                                      group=8), group=8)
    with torch.no_grad():
        ops.q4_matmul(x, *quantize_q4(torch.ones((8, 8), device=cuda),
                                      group=8), group=8)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("needs", ["both", "a", "b"])
def test_matmul_gradients_on_the_card_equal_autograd(cuda, transposed,
                                                     needs):
    """``ops.matmul`` with grad (a batched product, and a ``b`` given as the
    transpose of a contiguous tensor, as a tied unembedding is): the
    gradients equal autograd's f32 product within 1e-5 of the largest, one
    NN launch forward and one NT / TN launch for each gradient asked for
    (NN / TN for the transposed ``b``)."""
    g = torch.Generator(device=cuda).manual_seed(21)
    a = torch.randn((3, 300, 200), generator=g, device=cuda)
    b = torch.randn((3, 260, 200) if transposed else (3, 200, 260),
                    generator=g, device=cuda)
    a.requires_grad_(needs in ("both", "a"))
    b.requires_grad_(needs in ("both", "b"))
    gc = torch.randn((3, 300, 260), generator=g, device=cuda)

    def run(mm):
        out = mm(a, b.mT if transposed else b)
        return torch.autograd.grad(out, [x for x in (a, b)
                                         if x.requires_grad], gc)

    before = dict(kmatmul.launches_by_layout)
    got = run(ops.matmul)
    counts = {k: kmatmul.launches_by_layout[k] - before[k]
              for k in kmatmul.LAYOUTS}
    want = run(torch.matmul)
    for x, w in zip(got, want):
        assert x.shape == w.shape
        assert ((x - w).abs().max() / w.abs().max()).item() <= 1e-5
    grad_a, grad_b = needs in ("both", "a"), needs in ("both", "b")
    if transposed:
        assert counts == {"nn": int(grad_a), "nt": 1, "tn": int(grad_b)}
    else:
        assert counts == {"nn": 1, "nt": int(grad_a), "tn": int(grad_b)}


def test_parallel_mm_takes_the_kernel_for_float32_tiles(cuda):
    """``ParallelCtx.mm``'s rule: a float32 product with a full 128-row
    output tile (the folded rows; a tp rank's in the batched product) and
    at least one 128 x 128 output tile for every SM launches the panel
    kernel; one tile short of that, bf16, and a decode's few rows take
    ``torch.matmul``."""
    from repro_torch.models.parallel import dense
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(22)
    w = torch.randn((64, 128 * sms), generator=g, device=cuda)
    wr = torch.randn((2, 64, 64 * sms), generator=g, device=cuda)
    cases = [((2, 64, 64), w, torch.float32, 1),      # 128 folded rows
             ((2, 63, 64), w, torch.float32, 0),      # 126 rows
             ((2, 64, 64), w[:, :-128], torch.float32, 0),   # sms - 1 tiles
             ((1, 128 * sms, 64), w[:, :128], torch.float32, 1),  # by rows
             ((8, 1, 64), w, torch.float32, 0),       # decode
             ((2, 256, 64), w, torch.bfloat16, 0),    # bf16
             ((2, 128, 64), wr, torch.float32, 1),    # tp: 128 a rank
             ((2, 100, 64), wr, torch.float32, 0)]
    for shape, ww, dtype, launched in cases:
        x = torch.randn(shape, generator=g, device=cuda).to(dtype)
        ww = ww.to(dtype)
        before = kmatmul.launches_by_layout["nn"]
        got = dense(x, ww)
        assert kmatmul.launches_by_layout["nn"] - before == launched, \
            (shape, tuple(ww.shape))
        torch.testing.assert_close(got.float(), (x @ ww).float(),
                                   **_tol(dtype, 64))


@pytest.mark.parametrize("shape", [(2, 300, 70), (4, 2048, 256),
                                   (1, 129, 48)])
def test_lru_scan_autograd_launches_the_backward_kernel(cuda, shape):
    """``ops.lru_scan`` with grad: the forward kernel and, in the backward,
    ``csrc/lru_scan_bwd.cu`` (one launch each); dx and da within 2e-4 of
    the largest gradient of ``lru_scan_bwd_plain``."""
    from repro_torch.kernels import lru_scan_bwd as klrub
    g = torch.Generator(device=cuda).manual_seed(15)
    a = (torch.rand(shape, generator=g, device=cuda) * 0.499 + 0.5) \
        .requires_grad_(True)
    x = torch.randn(shape, generator=g, device=cuda, requires_grad=True)
    before = (klru.launches, klrub.launches)
    h = ops.lru_scan(a, x)
    gh = torch.randn(shape, generator=g, device=cuda)
    da, dx = torch.autograd.grad(h, (a, x), gh)
    assert (klru.launches - before[0], klrub.launches - before[1]) == (1, 1)
    want = klrub.lru_scan_bwd_plain(a.detach(), h.detach(), gh)
    for got, w in zip((dx, da), want):
        assert ((got - w).abs().max() / w.abs().max()).item() <= 2e-4


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "recurrentgemma-9b"])
def test_cluster_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced ``arch``'s hier step on 2x4: the card (the flash kernel
    and its backward; the MoE block's gather dispatch and combine; the
    hybrid's lru_scan kernel and its backward) against the CPU (the plain
    version's autograd): loss rtol 2e-4, gnorm 5e-3, the state under
    ``PERF.md`` §2's rule with at most 1e-5 of the params excused."""
    from repro_torch.kernels import lru_scan_bwd as klrub
    from repro_torch.analysis.state_rule import state_close
    from repro_torch.core import tree as T
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.runtime.steps import make_cluster_train_step
    cfg = get_config(arch).reduced(n_layers=2, d_model=128, n_heads=2)
    toks = torch.randint(0, cfg.vocab, (8, 65),
                         generator=torch.Generator().manual_seed(1))
    from repro_torch.optim.adamw import adamw_init
    res, params = {}, None
    for dev in (cuda, torch.device("cpu")):
        vc = VirtualCluster(pods=2, chips=4, device=dev)
        bundle = make_cluster_train_step(cfg, vc)
        if params is None:               # drawn on the card, from a seed
            params = T.tree_map(lambda t: t.cpu(),
                                bundle.model.init_params(0))
        p_dev = T.tree_map(lambda t: t.to(dev), params)
        m, v = adamw_init(p_dev)
        state = bundle.layout_state({"params": p_dev, "m": m, "v": v,
                                     "step": torch.zeros(
                                         (), dtype=torch.int32)})
        before = (kbwd.launches, klrub.launches)
        state, met = bundle.step(state, bundle.layout_batch(
            {"tokens": toks}))
        res[dev.type] = (float(met["loss"][0]), float(met["gnorm"][0]),
                         T.tree_map(lambda t: t.cpu(),
                                    bundle.unlayout_state(state)))
        if dev.type == "cuda":
            assert kbwd.launches > before[0]
            if arch == "recurrentgemma-9b":
                assert klrub.launches > before[1]
    (lg, gg, sg), (lc, gc, sc) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= 2e-4 * abs(lc) and abs(gg - gc) <= 5e-3 * gc
    # PERF.md §2's rule: m and v per leaf, the params but for elements
    # where AdamW's update is ill-conditioned, which must be few
    excused, total, _ = state_close(sg, sc, 1, "card vs CPU")
    assert excused <= 1e-5 * total, (excused, total)


def test_elastic_pod_loss_on_the_card_is_bit_identical(cuda, tmp_path):
    """The reduced qwen3-0.6b (2 layers, d 64) hier on 2x4 on the card: a
    pod lost at step 3, saves every 2 steps — one recovery 2x4 -> 1x4
    restored at step 2, its trajectory ``==`` a run started on 1x4 at step
    2, under deterministic algorithms; the flash kernels ran."""
    import os
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.runtime.elastic import (FaultEvent, FaultPlan,
                                             reference_run)
    from repro_torch.runtime.train_loop import train_elastic
    cfg = get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64,
                                           n_heads=4)
    vc = VirtualCluster(pods=2, chips=4, device=cuda)
    kw = dict(save_every=2, global_batch=8, seq=64)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        before = (kflash.launches, kbwd.launches)
        rep = train_elastic(cfg, vc, steps=6, ckpt_dir=str(tmp_path),
                            plan=FaultPlan((FaultEvent.pod_loss(3, pod=1),)),
                            **kw)
        assert kflash.launches > before[0] and kbwd.launches > before[1]
        ref = reference_run(cfg, vc.without_pod(1), ckpt_dir=str(tmp_path),
                            from_step=2, steps=6, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    (rec,) = rep.recoveries
    assert (rec.old_label, rec.new_label, rec.restored_step) == \
        ("2x4", "1x4", 2)
    assert sorted(ref.losses) == [2, 3, 4, 5]
    assert all(rep.losses[s] == ref.losses[s] for s in ref.losses)


def _serve_run(dev, label, decode=None, steps=2, arch="qwen3-0.6b",
               replay=None):
    """The reduced ``arch`` (d 128) in the serve_fsdp layout on ``label``:
    prefill (the train layout) of 2 prompts of 16 tokens, then ``steps``
    decode steps at per-slot positions; returns every step's logits (the
    first the prefill's), the final cache and an MoE model's routing
    (``moe.routes``; ``replay``: route as an earlier run did)."""
    from repro_torch.core import tree as T
    from repro_torch.models import moe
    from repro_torch.runtime.steps import cluster_ctx
    from repro_torch.substrate.cluster import P
    cfg = get_config(arch).reduced(d_model=128, n_heads=4)
    vc = VirtualCluster.from_label(label, device=dev)
    ctx = cluster_ctx(vc, opts=("serve_fsdp",))
    sizes = dict(zip(vc.axis_names, vc.axis_shapes))
    model = build(cfg, ctx, data=sizes[ctx.fsdp_axes[0]], device=dev)
    # drawn on the CPU in the ctx's tree (an MoE's expert leaves are
    # stored (tp, E / ep, ...)), the same on both devices
    params = T.tree_map(lambda t: t.to(dev), build(
        cfg, ctx, data=sizes[ctx.fsdp_axes[0]], device="cpu").init_params(0))
    fsdp = ctx.fsdp_axes[0]
    train = vc.layout(params, model.param_specs(tp_axis=ctx.tp_axis,
                                                fsdp_axis=fsdp))
    serve = vc.layout(params, model.param_specs(
        serve=True, tp_axis=ctx.tp_axis, fsdp_axis=fsdp))
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(2))
    decode = decode(model) if decode else model.decode_fn
    with vc.bind(), moe.routes(replay) as routes:
        cache, lg = model.prefill_fn(train, {"tokens": vc.layout(toks, P())},
                                     32)
        out = [lg[0].cpu()]
        pos = torch.tensor([16, 16])
        for _ in range(steps):
            tok = out[-1].argmax(-1).to(torch.int32)
            cache, lg = decode(serve, cache, vc.layout(tok, P()),
                               vc.layout(pos, P()))
            out.append(lg[0].cpu())
            pos = pos + 1
    return out, T.tree_map(lambda t: t.cpu(), dict(cache)), [
        t.cpu() for t in routes["idx"]]


@pytest.mark.parametrize("label,arch", [
    ("2x4", "qwen3-0.6b"), ("2x(2x2)", "qwen3-0.6b"),
    ("2x(2x2)", "recurrentgemma-9b"), ("2x4", "granite-moe-3b-a800m"),
    ("2x(2x2)", "granite-moe-3b-a800m")])
def test_cluster_decode_on_the_card_matches_the_cpu(cuda, label, arch):
    """Prefill (the flash kernel, and the hybrid's lru_scan kernel, on the
    card; their plain versions on the CPU) and two decode steps on the
    cluster: logits within 1e-4 relative.  An MoE model's routing tables
    are compared first; where a near-tie top k flips, the card runs again
    on the CPU's routing."""
    before = (kflash.launches, klru.launches)
    card, _, r_card = _serve_run(cuda, label, arch=arch)
    assert kflash.launches > before[0]
    assert klru.launches > before[1] or arch != "recurrentgemma-9b"
    cpu, _, r_cpu = _serve_run(torch.device("cpu"), label, arch=arch)
    assert len(r_card) == len(r_cpu) and bool(r_cpu) == ("moe" in arch)
    if not all(torch.equal(a.sort(-1)[0], b.sort(-1)[0])
               for a, b in zip(r_card, r_cpu)):
        card, _, _ = _serve_run(cuda, label, arch=arch, replay=r_cpu)
    for a, b in zip(card, cpu):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("label", ["2x4", "2x(2x2)"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_recorded_decode_on_the_card_is_bit_identical(cuda, label, arch):
    """RecordedDecoder against the sync decode on the card (the gathers
    front-loaded on the side stream; the MoE expert leaves read along
    their d_ff): logits and cache ``torch.equal``."""
    from repro_torch.serving.recorded import RecordedDecoder
    from repro_torch.core import tree as T
    sync, c_sync, _ = _serve_run(cuda, label, steps=3, arch=arch)
    rec, c_rec, _ = _serve_run(cuda, label, decode=RecordedDecoder, steps=3,
                               arch=arch)
    assert all(torch.equal(a, b) for a, b in zip(sync, rec))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(c_sync),
                                                 T.leaves(c_rec)))


def test_moe_block_on_the_card_is_deterministic_and_matches_the_cpu(cuda):
    """granite's full-width MoE block (d 1536, 40 experts, top 8) on 2 x 256
    tokens at capacity 1.25: the card's routing tables equal the CPU's
    (the flip count is 0 or the rows are compared where they agree), two
    forward + backward runs on the card are bit-identical (the gather
    dispatch and combine use no atomics), and output and gradients match
    the CPU within 1e-4 relative where the tables agree."""
    from repro_torch.models import meta, moe
    cfg = get_config("granite-moe-3b-a800m")
    defs = meta.moe_defs(cfg, 1, False)
    g = torch.Generator().manual_seed(3)
    p = {k: torch.randn(m.shape, generator=g) * (0.02 if k != "ln" else 0)
         for k, m in defs.items()}
    x = torch.randn((2, 256, cfg.d_model), generator=g)
    ctx = ParallelCtx.single()

    def run(dev):
        xd = x.to(dev).requires_grad_(True)
        pd = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        y = moe.moe_block(xd, pd, defs, ctx, cfg)
        gx, gw = torch.autograd.grad((y * y).sum(), (xd, pd["w_in"]))
        h = moe.rms_norm(x.to(dev), p["ln"].to(dev), cfg.norm_eps)
        idx, _ = moe.route(h.reshape(-1, cfg.d_model), p["router"].to(dev),
                           cfg.moe.top_k)
        return [t.detach().cpu() for t in (y, gx, gw, idx)]

    a, b, c = run(cuda), run(cuda), run(torch.device("cpu"))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    same = (a[3] == c[3]).all(-1).reshape(2, 256)
    assert same.float().mean() > 0.95
    for u, v in zip(a[:2], c[:2]):
        assert (u[same] - v[same]).abs().max() <= 1e-4 * v.abs().max()
    if bool(same.all()):
        assert (a[2] - c[2]).abs().max() <= 1e-4 * c[2].abs().max()


def test_xlstm_blocks_on_the_card_match_the_cpu(cuda):
    """``xlstm-1.3b``'s full-width blocks (d 2048, 4 heads of 1024, d_inner
    4096) on 2 x 250 tokens (the mLSTM's ragged last chunk): forward and
    the gradients of x and every weight, then 2 decode steps from the
    prefill state, card against CPU within 1e-4 relative; no flash or
    lru_scan launch (the reference's blocks reach no Pallas kernel), the
    prefill's and the gradients' products through the panel kernel."""
    from repro_torch.models import meta, xlstm
    cfg = get_config("xlstm-1.3b")
    ctx = ParallelCtx.single()
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 250, cfg.d_model), generator=g)
    steps = torch.randn((2, 2, 1, cfg.d_model), generator=g)
    for kind, fn in (("mlstm", xlstm.mlstm_block),
                     ("slstm", xlstm.slstm_block)):
        defs = meta.block_defs(kind, cfg, 1, False)[kind]
        p = {k: torch.randn(m.shape, generator=g) * 0.02
             for k, m in defs.items()}

        def run(dev, p=p, defs=defs, fn=fn):
            xd = x.to(dev).requires_grad_(True)
            pd = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
            y, st = fn(xd, pd, defs, ctx, cfg, return_state=True)
            grads = torch.autograd.grad((y * y).sum(), [xd] + list(
                pd.values()))
            out = [y.detach()] + list(grads)
            with torch.no_grad():
                for s in steps:
                    yd, st = fn(s.to(dev), pd, defs, ctx, cfg, state=st,
                                decode=True)
                    out.append(yd)
            return [t.cpu() for t in out]

        before = (kflash.launches, klru.launches, kmatmul.launches)
        card = run(cuda)
        assert (kflash.launches, klru.launches) == before[:2]
        assert kmatmul.launches > before[2]
        for a, b in zip(card, run(torch.device("cpu"))):
            assert torch.isfinite(a).all(), kind
            assert (a - b).abs().max() <= 1e-4 * b.abs().max(), kind


@pytest.mark.parametrize("label", ["2x4", "2x(2x2)"])
def test_xlstm_cluster_train_step_on_the_card_matches_the_cpu(cuda, label):
    """The reduced ``xlstm-1.3b`` (one unit, d 128, 2 heads) hier step on
    ``label``: the card against the CPU, loss rtol 2e-4, gnorm 5e-3, the
    state under ``PERF.md`` §2's rule with at most 1e-5 of the params
    excused."""
    from repro_torch.analysis.state_rule import state_close
    from repro_torch.core import tree as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import make_cluster_train_step
    cfg = get_config("xlstm-1.3b").reduced(d_model=128, n_heads=2)
    toks = torch.randint(0, cfg.vocab, (8, 161),
                         generator=torch.Generator().manual_seed(1))
    res, params = [], None
    for dev in (cuda, torch.device("cpu")):
        vc = VirtualCluster.from_label(label, device=dev)
        bundle = make_cluster_train_step(cfg, vc)
        if params is None:
            params = T.tree_map(lambda t: t.cpu(),
                                bundle.model.init_params(0))
        p_dev = T.tree_map(lambda t: t.to(dev), params)
        m, v = adamw_init(p_dev)
        state = bundle.layout_state({"params": p_dev, "m": m, "v": v,
                                     "step": torch.zeros(
                                         (), dtype=torch.int32)})
        state, met = bundle.step(state, bundle.layout_batch(
            {"tokens": toks}))
        res.append((float(met["loss"][0]), float(met["gnorm"][0]),
                    T.tree_map(lambda t: t.cpu(),
                               bundle.unlayout_state(state))))
    (lg, gg, sg), (lc, gc, sc) = res
    assert abs(lg - lc) <= 2e-4 * abs(lc) and abs(gg - gc) <= 5e-3 * gc
    excused, total, _ = state_close(sg, sc, 1, f"xlstm {label} card vs CPU")
    assert excused <= 1e-5 * total, (excused, total)


@pytest.mark.parametrize("label", ["2x4", "2x(2x2)"])
def test_xlstm_cluster_decode_on_the_card(cuda, label):
    """The reduced ``xlstm-1.3b`` served on ``label``: prefill and two
    decode steps on the card against the CPU within 1e-4 relative, and
    ``RecordedDecoder`` bit-identical to the sync decode on the card."""
    from repro_torch.core import tree as T
    from repro_torch.serving.recorded import RecordedDecoder
    card, c_card, _ = _serve_run(cuda, label, steps=3, arch="xlstm-1.3b")
    cpu, _, _ = _serve_run(torch.device("cpu"), label, steps=3,
                           arch="xlstm-1.3b")
    for a, b in zip(card, cpu):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    rec, c_rec, _ = _serve_run(cuda, label, decode=RecordedDecoder, steps=3,
                               arch="xlstm-1.3b")
    assert all(torch.equal(a, b) for a, b in zip(card, rec))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(c_card),
                                                 T.leaves(c_rec)))


def test_spans_time_on_the_card_and_stay_off_its_timeline(cuda):
    """``core.spans`` on the card: a span is a host event only, where a
    ``record_function`` range gets a device-timeline annotation too; while
    a profiler records, its CUDA event pair times the work inside it, and
    with none recording it records nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import spans
    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    spans.reset()
    with spans.span("test::off"):
        x @ x
    assert spans.totals() == {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("test::user"):
            x @ x
        with spans.span("test::span"):
            for _ in range(4):
                x @ x
        torch.cuda.synchronize()
    device = {e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA}
    assert "test::user" in device and "test::span" not in device
    (host,) = [e for e in prof.events() if e.name == "test::span"]
    assert host.device_type == DeviceType.CPU
    assert not host.is_user_annotation
    got = spans.totals()["test::span"]
    assert got["calls"] == 1 and got["ms"] > 0
    # the event pair spans the four products' device time
    assert got["ms"] * 1e3 >= 0.9 * host.device_time_total
    spans.reset()


# the grouped entry: uneven segments, an empty one first and one in the
# middle, one of more than 4k rows; (segment rows, K, N) aligned and ragged
GROUPED_CASES = [((0, 4100, 1, 130, 0, 77), 256, 384),
                 ((3, 0, 129, 4097, 5), 130, 70)]


def _grouped_operands(g, dev, layout, counts, K, N):
    """The grouped entry's operands in ``layout`` for segments of
    ``counts`` rows, and their offsets."""
    R, G = sum(counts), len(counts)
    off = torch.tensor([0] + list(counts), device=dev).cumsum(0).int()
    if layout == "tn":         # dW: a (R, M = K), b (R, N)
        a = torch.randn((R, K), generator=g, device=dev)
        b = torch.randn((R, N), generator=g, device=dev)
    else:
        a = torch.randn((R, K), generator=g, device=dev)
        b = torch.randn((G,) + ((N, K) if layout == "nt" else (K, N)),
                        generator=g, device=dev)
    return a, b, off


@pytest.mark.parametrize("case", GROUPED_CASES, ids=str)
@pytest.mark.parametrize("layout", kmatmul.LAYOUTS)
def test_grouped_kernel_against_float64_and_torch_matmul(cuda, case, layout):
    """Each segment's product against the float64 product: the kernel's
    largest error over the largest |C| at most twice ``torch.matmul``'s f32
    one on the same segment, or 2e-6 grown as sqrt(depth / 1024) past a
    depth of 1024 (a shallow TN segment, 3 rows deep, is off by 3xTF32's
    representation error, ~2.4e-7, where cuBLAS's 3-term sums are exact);
    an empty segment gives no rows (NN / NT) or a zero dW (TN); one launch,
    counted by layout; the plain version agrees."""
    counts, K, N = case
    g = torch.Generator(device=cuda).manual_seed(21)
    a, b, off = _grouped_operands(g, cuda, layout, counts, K, N)
    before = kmatmul.grouped_launches_by_layout[layout]
    got = kmatmul.grouped_matmul_cuda(a, b, off, layout)
    torch.cuda.synchronize()
    assert kmatmul.grouped_launches_by_layout[layout] == before + 1
    o = off.tolist()
    for s in range(len(counts)):
        rows = slice(o[s], o[s + 1])
        if layout == "tn":
            x, y, kern = a[rows].T, b[rows], got[s]
        else:
            x, y = a[rows], (b[s].T if layout == "nt" else b[s])
            kern = got[rows]
        want = x.double() @ y.double()
        if want.numel() == 0 or counts[s] == 0:
            assert not kern.any()
            continue
        top = want.abs().max()
        err = ((kern.double() - want).abs().max() / top).item()
        lib_err = (((x @ y).double() - want).abs().max() / top).item()
        depth = x.shape[1]
        assert err <= max(2 * lib_err, 2e-6 * max(1, depth / 1024) ** 0.5), \
            (s, err, lib_err)
    torch.testing.assert_close(
        got, kmatmul.grouped_matmul_plain(a, b, off, layout),
        **_tol(torch.float32, max(counts) if layout == "tn" else K))


def test_grouped_matmul_gradients_on_the_card_equal_autograd(cuda):
    """``ops.grouped_matmul`` with grad: the forward on NN, dX on NT and
    dW on TN, one launch each, equal to the autograd of the segments' f32
    products within 2e-4 relative; an empty segment's dW is zero."""
    counts = (0, 300, 4100, 1, 0, 95)
    g = torch.Generator(device=cuda).manual_seed(22)
    x, w, off = _grouped_operands(g, cuda, "nn", counts, 192, 320)
    dy = torch.randn((sum(counts), 320), generator=g, device=cuda)
    xk, wk = (t.clone().requires_grad_(True) for t in (x, w))
    before = dict(kmatmul.grouped_launches_by_layout)
    (ops.grouped_matmul(xk, wk, off) * dy).sum().backward()
    torch.cuda.synchronize()
    assert {k: kmatmul.grouped_launches_by_layout[k] - before[k]
            for k in kmatmul.LAYOUTS} == {"nn": 1, "nt": 1, "tn": 1}
    xp, wp = (t.clone().requires_grad_(True) for t in (x, w))
    o = off.tolist()
    ref = torch.cat([xp[o[s]:o[s + 1]] @ wp[s] for s in range(len(counts))])
    (ref * dy).sum().backward()
    for got, want in ((xk.grad, xp.grad), (wk.grad, wp.grad)):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-4
    assert not wk.grad[0].any() and not wk.grad[4].any()


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
def test_flash_kernels_take_a_given_scale(cuda, layout):
    """Granite's softmax scale (1 / 64 at hd 64, not 1 / 8) through the
    forward and backward kernels, against ``scaled_dot_product_attention``
    at that scale (f32, 2e-4 of the largest value); without a scale both
    launches are bit-identical to the ones given 1 / sqrt(hd)."""
    import math
    import torch.nn.functional as F
    B, H, KV, T, hd = 2, 24, 8, 200, 64
    g = torch.Generator(device=cuda).manual_seed(23)
    shp = (lambda n: (B, T, n, hd)) if layout == "bthd" else \
        (lambda n: (B, n, T, hd))
    q, do = (torch.randn(shp(H), generator=g, device=cuda) for _ in range(2))
    k, v = (torch.randn(shp(KV), generator=g, device=cuda) for _ in range(2))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, layout=layout, scale=1 / 64)
    got = (out,) + torch.autograd.grad(out, (q, k, v), do)

    def bhtd(t):
        return t.transpose(1, 2) if layout == "bthd" else t

    qs, ks, vs = (bhtd(t.detach()).requires_grad_(True) for t in (q, k, v))
    ref = F.scaled_dot_product_attention(
        qs, ks.repeat_interleave(H // KV, 1), vs.repeat_interleave(H // KV, 1),
        is_causal=True, scale=1 / 64)
    want = (ref,) + torch.autograd.grad(ref, (qs, ks, vs), bhtd(do))
    for a, b in zip(got, want):
        b = bhtd(b)
        assert ((a - b).abs().max() / b.abs().max()).item() <= 2e-4
    from repro_torch.kernels import flash_attention_bwd as kbwd
    with torch.no_grad():
        kw = dict(layout=layout)
        o1, l1 = kflash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        o2, l2 = kflash.flash_attention_cuda(q, k, v, return_lse=True,
                                             scale=1 / math.sqrt(hd), **kw)
        assert torch.equal(o1, o2) and torch.equal(l1, l2)
        g1 = kbwd.flash_attention_bwd_cuda(q, k, v, o1, do, l1, **kw)
        g2 = kbwd.flash_attention_bwd_cuda(q, k, v, o1, do, l1,
                                           scale=1 / math.sqrt(hd), **kw)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_dropless_moe_block_on_the_card_matches_the_cpu(cuda):
    """granite's full-width MoE block, dropless (every token reaches its 8
    experts through the grouped kernel), on 2 x 256 tokens with its
    residual multiplier: two forward + backward runs on the card are
    bit-identical, and output and gradients match the CPU within 1e-4
    relative where the routing agrees (as the capacity block's test); the
    card runs one launch of each ``moe_gather`` entry, the CPU none."""
    from repro_torch.configs.base import MoESpec
    from repro_torch.models import meta, moe
    base = get_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(base, residual_scale=0.22, moe=MoESpec(
        num_experts=40, top_k=8, d_ff_expert=512, capacity_factor=None))
    defs = meta.moe_defs(cfg, 1, False)
    g = torch.Generator().manual_seed(3)
    p = {k: torch.randn(m.shape, generator=g) * (0.02 if k != "ln" else 0)
         for k, m in defs.items()}
    x = torch.randn((2, 256, cfg.d_model), generator=g)
    ctx = ParallelCtx.single()

    def run(dev):
        xd = x.to(dev).requires_grad_(True)
        pd = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        before = dict(kmatmul.grouped_launches_by_layout)
        rows_before = dict(kmoe.launches)
        y = moe.moe_block(xd, pd, defs, ctx, cfg)
        gx, gw = torch.autograd.grad((y * y).sum(), (xd, pd["w_in"]))
        launched = {k: kmatmul.grouped_launches_by_layout[k] - before[k]
                    for k in kmatmul.LAYOUTS}
        launched.update({k: kmoe.launches[k] - rows_before[k]
                         for k in kmoe.ENTRIES})
        h = moe.rms_norm(x.to(dev), p["ln"].to(dev), cfg.norm_eps)
        idx, _ = moe.route(h.reshape(-1, cfg.d_model), p["router"].to(dev),
                           cfg.moe.top_k)
        return [t.detach().cpu() for t in (y, gx, gw, idx)], launched

    (a, n_a), (b, _), (c, n_c) = run(cuda), run(cuda), run(
        torch.device("cpu"))
    assert n_a == {"nn": 2, "nt": 2, "tn": 2, "dispatch": 1, "combine": 1,
                   "combine_bwd": 1, "dispatch_bwd": 1}
    assert not any(n_c.values())
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    same = (a[3] == c[3]).all(-1).reshape(2, 256)
    assert same.float().mean() > 0.95
    for u, v in zip(a[:2], c[:2]):
        assert (u[same] - v[same]).abs().max() <= 1e-4 * v.abs().max()
    if bool(same.all()):
        assert (a[2] - c[2]).abs().max() <= 1e-4 * c[2].abs().max()


def _moe_gather_all(x, table, src, g, inv, back, dy, d_buf, kernel):
    """The four ``moe_gather`` entries on one set of operands: their kernels
    or their plain versions (the composition they replace)."""
    tail = "cuda" if kernel else "plain"
    if kernel:
        x, table, src, g, inv, back, dy, d_buf = (
            t.contiguous() for t in (x, table, src, g, inv, back, dy, d_buf))
    return (getattr(kmoe, f"dispatch_{tail}")(x, table, inv),
            getattr(kmoe, f"combine_{tail}")(src, g, inv),
            *getattr(kmoe, f"combine_bwd_{tail}")(dy, g, inv, src, back),
            getattr(kmoe, f"dispatch_bwd_{tail}")(d_buf, inv))


def _moe_gather_check(ops_, d_g_tol):
    """Kernels against plain versions: buf, y, d_src and dx bit for bit,
    d_g within ``d_g_tol`` of a float64 dot product's largest entry; a
    second run of the kernels bit-identical; one launch of each entry."""
    before = dict(kmoe.launches)
    got = _moe_gather_all(*ops_, kernel=True)
    again = _moe_gather_all(*ops_, kernel=True)
    torch.cuda.synchronize()
    assert {e: kmoe.launches[e] - before[e] for e in kmoe.ENTRIES} == \
        dict.fromkeys(kmoe.ENTRIES, 2)
    want = _moe_gather_all(*ops_, kernel=False)
    for name, a, b, c in zip(("buf", "y", "d_src", "d_g", "dx"), got, again,
                             want):
        assert a.dtype == c.dtype and torch.equal(a, b), name
        if name != "d_g":
            assert torch.equal(a, c), name
    _, _, src, _, inv, _, dy, _ = ops_
    d_g64 = (dy.double()[:, :, None, :]
             * kmoe.gather_rows(src.double(), inv)).sum(-1)
    err = (got[3].double() - d_g64).abs().max() / d_g64.abs().max()
    assert err.item() <= d_g_tol, err.item()
    return got


def test_moe_gather_kernels_at_granite_width(cuda):
    """granite's dropless block as the benchmark's cell runs it: a node
    run's M = 8192 tokens routed top 8 of 40 by a seeded router (real
    skew), d 1536, f32; the tables of ``segment_tables`` /
    ``combine_tables`` (no sentinel).  The kernels' buffers, combined rows,
    buffers' gradient and tokens' gradient equal the plain composition bit
    for bit, the gates' gradient is within 1e-6 of float64, two runs are
    bit-identical."""
    from repro_torch.models import moe
    M, k, E, d = 8192, 8, 40, 1536
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn((1, M, d), generator=g, device=cuda) + torch.randn(
        (d,), generator=g, device=cuda)          # a shared direction: skew
    router = torch.randn((d, E), generator=g, device=cuda) * 0.05
    idx, gate = moe.route(x[0], router, k)
    order, counts, _ = moe.segment_tables(idx, E)
    assert int(counts.max()) > 1.5 * M * k / E           # skewed segments
    slot = order.reshape(1, 1, M * k)
    inv, perm, back = moe.combine_tables(slot, M, k)
    src = torch.randn((1, M * k, d), generator=g, device=cuda)
    dy = torch.randn((1, M, d), generator=g, device=cuda)
    d_buf = torch.randn((1, M * k, d), generator=g, device=cuda)
    gs = torch.gather(gate[None], -1, perm)
    _moe_gather_check((x, (slot // k).reshape(1, M * k), src, gs, inv,
                       back.reshape(1, M * k), dy, d_buf), 1e-6)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 1536),
                                     (torch.bfloat16, 1536),
                                     (torch.float32, 98)], ids=str)
def test_moe_gather_kernels_on_the_capacity_path(cuda, dtype, d):
    """The capacity path's tables, batched as ``moe_block`` batches them:
    b = 3 (tp ranks x members; expert groups e0 0 / 20 / 0 of 40 at ep 2),
    512 tokens top 8 at capacity 1.25, so dropped slots (a sentinel in inv)
    and empty cells (one in table and back); f32 and bf16 (every product
    and sum rounded as the plain version's bf16 ops), and a row of 392
    bytes (element-wise loads).  As at granite width; d_g within 1e-6 of
    float64 (bf16: 1e-2)."""
    from repro_torch.models import moe
    b, N, k, E, n_local = 3, 512, 8, 40, 20
    g = torch.Generator(device=cuda).manual_seed(32)
    idx = torch.stack([torch.argsort(torch.rand((N, E), generator=g,
                                                device=cuda), -1)[:, :k]
                       for _ in range(b)])
    e0 = torch.tensor([[0], [20], [0]], device=cuda)
    C = int(N * k / E * 1.25) + 1
    table, slot = moe.dispatch_tables(idx, e0=e0, n_local=n_local,
                                      capacity=C)
    inv, perm, back = moe.combine_tables(slot, N, k)
    S = n_local * C
    assert bool((inv == S).any()) and bool((table == N).any())
    x = torch.randn((b, N, d), generator=g, device=cuda).to(dtype)
    src = torch.randn((b, S, d), generator=g, device=cuda).to(dtype)
    dy = torch.randn((b, N, d), generator=g, device=cuda).to(dtype)
    d_buf = torch.randn((b, S, d), generator=g, device=cuda).to(dtype)
    gate = torch.softmax(torch.randn((b, N, k), generator=g, device=cuda),
                         -1)
    gs = torch.gather(gate, -1, perm).to(dtype)
    got = _moe_gather_check((x, table.reshape(b, S), src, gs, inv,
                             back.reshape(b, S), dy, d_buf),
                            1e-6 if dtype == torch.float32 else 1e-2)
    empty = back.reshape(b, S) == N * k
    assert not got[2][empty].any()
    assert not got[3][inv == S].any()


def test_moe_gather_launches_in_a_granite_step(cuda):
    """One hier 2x4 step of granite as the benchmark's cell configures it
    (8 of 32 layers, published widths and multipliers, dropless top 8 of
    40; 8 x 256 tokens): each layer's block in each of the 2 node runs
    launches dispatch and combine in its forward and again in the
    recompute, combine_bwd and dispatch_bwd once: 32 / 32 / 16 / 16."""
    import numpy as np
    from repro_torch.configs.base import MoESpec
    from repro_torch.runtime.steps import make_cluster_train_step
    cfg = dataclasses.replace(
        get_config("granite-moe-3b-a800m"), n_layers=8, tie_embeddings=True,
        embed_scale=12.0, residual_scale=0.22, attn_scale=1 / 64,
        logit_scale=6.0, mask_vocab_pad=True,
        moe=MoESpec(num_experts=40, top_k=8, d_ff_expert=512,
                    capacity_factor=None))
    vc = VirtualCluster(pods=2, chips=4, device=cuda)
    bundle = make_cluster_train_step(cfg, vc, mode="hier", global_batch=8)
    state = bundle.init_layout_state(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(8, 256))
    batch = bundle.layout_batch({"tokens": toks})
    before = dict(kmoe.launches)
    state, mt = bundle.step(state, batch)
    torch.cuda.synchronize()
    assert {e: kmoe.launches[e] - before[e] for e in kmoe.ENTRIES} == {
        "dispatch": 32, "combine": 32, "combine_bwd": 16, "dispatch_bwd": 16}
    assert torch.isfinite(mt["loss"]).all()
