"""Hopper panel-matmul kernel: bind, launch — and its plain version.

The kernel (``csrc/matmul.cu``) replaces the TPU kernel
``src/repro/kernels/matmul.py::matmul_pallas``, the SUMMA per-panel product.
It is CUDA C++ for ``sm_90a`` with a plain C interface, built at first use by
``kernels._cuda`` and loaded with ``ctypes``: warpgroup tensor-core products
(``wgmma``) in 3xTF32 for f32, about as accurate as an fp32 FMA loop.  It
adds its K / 32 tile sums in order, an fp32 sum whose error walks as
sqrt(K), where cuBLAS may split a deep K: on an H100, against a float64
product, the training step's products at K <= 8192 are off by 4.3-9.3e-7
of the largest |C| (``torch.matmul`` f32: 1.5-3.4e-6), the unembedding's
dX at K 151,936 by 3.2-3.4e-6 (``torch.matmul``: 1.4e-6, so 2.2-2.4x;
the tests hold it to 2x ``torch.matmul``'s error or 2e-6 grown as
sqrt(K / 1024)).  The source's header note says what bounds it and what
the design gives up.

Three operand layouts (``LAYOUTS``), each operand row-major as given: ``nn``
``a (M, K) @ b (K, N)``; ``nt`` ``a (M, K) @ b.T`` for ``b (N, K)``; ``tn``
``a.T @ b`` for ``a (K, M)``, ``b (K, N)`` — a product's forward and its two
gradients (``ops.Matmul``), each reading its operands where they lie.

``matmul_cuda`` is the wrapper: it checks device, dtype, shape and
contiguity, raises on anything else, launches on the current stream and
counts the launch in ``launches`` and, by layout, in
``launches_by_layout``.  ``recomputes`` counts, on the card, the output
tiles that the non-finite rule recomputed with the fp32 FMA loop
(``csrc/tf32x3.cuh``): 0 wherever operands and product are finite.
``matmul_plain`` is the same function in plain PyTorch (fp32 product, cast
to ``a.dtype`` — ``ref.matmul_ref``; float64 operands stay float64); it
serves CPU tensors and is what the card's result is held against.

The grouped entry (``grouped_matmul_cuda``) runs the same tile loop over
segments of rows sorted by group, the offsets (``G + 1`` int32) on the
device: ``nn`` ``a (R, K)`` with ``b (G, K, N)`` -> ``(R, N)``, segment g's
rows times ``b[g]``; ``nt`` the same with ``b (G, N, K)`` read as ``b[g].T``;
``tn`` ``a (R, M)``, ``b (R, N)`` -> ``(G, M, N)``, ``a_g.T @ b_g`` over
segment g's rows (zeros for an empty one).  The dropless MoE block's
expert products and their gradients.  It counts its launches in
``grouped_launches_by_layout``; ``grouped_matmul_plain`` is its plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda

SOURCE = _cuda.CSRC / "matmul.cu"

#: The operand layouts, in the order of the kernel's layout codes.
LAYOUTS = ("nn", "nt", "tn")
#: Kernel launches made through ``matmul_cuda`` (reset it to 0 to count a run).
launches = 0
#: The same launches by layout.
launches_by_layout = dict.fromkeys(LAYOUTS, 0)
#: Output tiles recomputed under the non-finite rule (``recomputes.read()``,
#: ``recomputes.reset()``).
recomputes = _cuda.DeviceCounter()

#: Grouped-entry launches by layout (``grouped_matmul_cuda``).
grouped_launches_by_layout = dict.fromkeys(LAYOUTS, 0)

_ENTRY = {torch.float32: "repro_matmul_f32",
          torch.bfloat16: "repro_matmul_bf16"}
_GROUPED_ENTRY = {torch.float32: "repro_grouped_matmul_f32",
                  torch.bfloat16: "repro_grouped_matmul_bf16"}


@functools.lru_cache(maxsize=None)
def library() -> _cuda.Library:
    """Build ``csrc/matmul.cu`` (once per source hash), load it and bind
    its entry points."""
    lib = _cuda.library(SOURCE.name)
    for name in _ENTRY.values():
        fn = getattr(lib.cdll, name)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _grouped_entry(dtype: torch.dtype):
    """The grouped entry point for ``dtype`` in ``library()``, bound at its
    first launch."""
    fn = getattr(library().cdll, _GROUPED_ENTRY[dtype])
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _check(a: torch.Tensor, b: torch.Tensor, layout: str,
           dtypes=tuple(_ENTRY)) -> tuple[int, int, int, int]:
    """Shape/dtype contract shared by the kernel and its plain version:
    ``nn`` (M, K) @ (K, N), ``nt`` (M, K) @ (N, K)^T, ``tn`` (K, M)^T @
    (K, N), or a leading batch on both; both f32 or both bf16 (the plain
    version also float64).  Returns (batch, M, N, K)."""
    if layout not in LAYOUTS:
        raise ValueError(f"matmul layout must be one of {LAYOUTS}, got "
                         f"{layout!r}")
    if a.dtype != b.dtype or a.dtype not in dtypes:
        raise TypeError(f"matmul takes two operands of one dtype of "
                        f"{dtypes}, got {a.dtype} and {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"matmul takes 2-d operands or 3-d ones with a "
                         f"leading batch, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)} ({layout})")
    ra, ca = a.shape[-2:]
    rb, cb = b.shape[-2:]
    M, Ka = (ca, ra) if layout == "tn" else (ra, ca)
    Kb, N = (cb, rb) if layout == "nt" else (rb, cb)
    if Ka != Kb or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul shapes do not match: {tuple(a.shape)} and "
                         f"{tuple(b.shape)} ({layout})")
    return (a.shape[0] if a.dim() == 3 else 1), M, N, Ka


def _op(x: torch.Tensor, transposed: bool) -> torch.Tensor:
    return x.transpose(-1, -2) if transposed else x


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 layout: str = "nn") -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 product (float64 for
    float64 operands) of the layout's ``op(a) @ op(b)``, output in
    ``a.dtype``.  (On the card, a caller disables TF32 to make this the
    IEEE fp32 product.)"""
    _check(a, b, layout, dtypes=tuple(_ENTRY) + (torch.float64,))
    wide = torch.promote_types(a.dtype, torch.float32)
    return (_op(a, layout == "tn").to(wide)
            @ _op(b, layout == "nt").to(wide)).to(a.dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                layout: str = "nn") -> torch.Tensor:
    """Launch the Hopper kernel on the layout's ``op(a) @ op(b)``
    (contiguous CUDA operands, each row-major as given)."""
    global launches
    batch, M, N, K = _check(a, b, layout)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul_cuda needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda needs contiguous operands")
    if batch > 65535 or (M + 127) // 128 > 65535 or max(M, N, K) >= 2**31:
        raise ValueError(f"matmul_cuda grid limit exceeded by "
                         f"{tuple(a.shape)} and {tuple(b.shape)} ({layout})")
    out = torch.empty(tuple(a.shape[:-2]) + (M, N), dtype=a.dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    fn = getattr(library().cdll, _ENTRY[a.dtype])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(LAYOUTS.index(layout), a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), batch, M, N, K, M * K, K * N, M * N,
                 recomputes.buffer(a.device).data_ptr(), stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed with CUDA error "
                           f"{err} for {tuple(a.shape)} and "
                           f"{tuple(b.shape)} ({layout})")
    launches += 1
    launches_by_layout[layout] += 1
    return out


def _check_grouped(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                   layout: str, dtypes=tuple(_ENTRY)
                   ) -> tuple[int, int, int, int]:
    """Shape/dtype contract of the grouped entry and its plain version:
    ``nn`` a (R, K), b (G, K, N); ``nt`` a (R, K), b (G, N, K); ``tn`` a
    (R, M), b (R, N); offsets (G + 1,) int32 on a's device.  Returns (G, M,
    N, K), R being M (``nn`` / ``nt``) or K (``tn``).  The offsets' values
    (rising from 0 to R) are the caller's to keep: the kernel reads them on
    the device, the plain version checks them."""
    if layout not in LAYOUTS:
        raise ValueError(f"grouped matmul layout must be one of {LAYOUTS}, "
                         f"got {layout!r}")
    if a.dtype != b.dtype or a.dtype not in dtypes:
        raise TypeError(f"grouped matmul takes two operands of one dtype of "
                        f"{dtypes}, got {a.dtype} and {b.dtype}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1 \
            or offsets.numel() < 2 or offsets.device != a.device:
        raise ValueError(f"grouped matmul takes (G + 1,) int32 offsets on "
                         f"{a.device}, got {tuple(offsets.shape)} "
                         f"{offsets.dtype} on {offsets.device}")
    G = offsets.numel() - 1
    if layout == "tn":
        ok = a.dim() == 2 and b.dim() == 2 and a.shape[0] == b.shape[0]
    else:
        ok = a.dim() == 2 and b.dim() == 3 and b.shape[0] == G and \
            a.shape[1] == b.shape[2 if layout == "nt" else 1]
    if not ok:
        raise ValueError(f"grouped matmul shapes do not match: "
                         f"{tuple(a.shape)} and {tuple(b.shape)} with {G} "
                         f"groups ({layout})")
    if layout == "tn":
        return G, a.shape[1], b.shape[1], a.shape[0]
    return G, a.shape[0], b.shape[1 if layout == "nt" else 2], a.shape[1]


def grouped_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                         offsets: torch.Tensor, layout: str = "nn"
                         ) -> torch.Tensor:
    """The grouped entry's function in plain PyTorch, segment by segment
    (``matmul_plain``'s precision; the offsets read on the host)."""
    G = _check_grouped(a, b, offsets, layout,
                       dtypes=tuple(_ENTRY) + (torch.float64,))[0]
    off = offsets.tolist()
    if off[0] != 0 or off[-1] != a.shape[0] or any(
            x > y for x, y in zip(off, off[1:])):
        raise ValueError(f"grouped matmul offsets must rise from 0 to "
                         f"{a.shape[0]}, got {off}")
    seg = [slice(off[g], off[g + 1]) for g in range(G)]
    if layout == "tn":
        return torch.stack([matmul_plain(a[s], b[s], "tn") for s in seg])
    return torch.cat([matmul_plain(a[s], b[g], layout)
                      for g, s in enumerate(seg)])


def grouped_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                        offsets: torch.Tensor, layout: str = "nn"
                        ) -> torch.Tensor:
    """Launch the grouped entry in ``layout`` (contiguous CUDA operands, the
    offsets on the same device)."""
    G, M, N, K = _check_grouped(a, b, offsets, layout)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"grouped_matmul_cuda needs both operands on one "
                         f"CUDA device, got {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("grouped_matmul_cuda needs contiguous operands")
    if (M + 127) // 128 + G > 65535 or max(M, N, K) >= 2**31:
        raise ValueError(f"grouped_matmul_cuda grid limit exceeded by "
                         f"{tuple(a.shape)} and {tuple(b.shape)} ({layout})")
    shape = (G, M, N) if layout == "tn" else (M, N)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = _grouped_entry(a.dtype)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(LAYOUTS.index(layout), a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), offsets.data_ptr(), G, M, N, K,
                 recomputes.buffer(a.device).data_ptr(), stream)
    if err:
        raise RuntimeError(f"grouped matmul kernel launch failed with CUDA "
                           f"error {err} for {tuple(a.shape)} and "
                           f"{tuple(b.shape)} ({layout})")
    grouped_launches_by_layout[layout] += 1
    return out
