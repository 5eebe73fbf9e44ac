"""The port on a CUDA card: the Hopper kernel and the stream-ordered paths.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports nothing of JAX, so it also runs on a machine that has only
PyTorch (the suite's conftest imports the JAX package, hence
``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

The kernel is held against its plain version with the reference kernel
tests' tolerances (F32 2e-4 / BF16 2e-2, rtol K-scaled, atol x8).  The
card's collectives and fused collective-matmuls (side stream + events) are
held against the same code run on the CPU: gathers bit for bit, products
and sums within 1e-5.
"""

import pytest
import torch

from repro_torch.analysis import traffic
from repro_torch.comm import Communicator
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops
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
                                   (3, 129, 131, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    *batch, M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((*batch, M, K), generator=g, device=cuda).to(dtype)
    b = torch.randn((*batch, K, N), generator=g, device=cuda).to(dtype)
    before = kmatmul.launches
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert kmatmul.launches == before + 1
    assert got.shape == (*batch, M, N) and got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               kmatmul.matmul_plain(a, b).float(),
                               **_tol(dtype, K))


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
