"""Hopper panel-matmul kernel: build, bind, launch — and its plain version.

The kernel (``csrc/matmul.cu``) replaces the TPU kernel
``src/repro/kernels/matmul.py::matmul_pallas``, the SUMMA per-panel product.
It is CUDA C++ for ``sm_90a`` with a plain C interface: ``nvcc`` builds it
into a shared library at first use (into ``_build/`` beside the package,
keyed by the source's hash) and ``ctypes`` loads it.  The source's header
note says what bounds it and what the simple design gives up.

``matmul_cuda`` is the wrapper: it checks device, dtype, shape and
contiguity, raises on anything else, launches on the current stream and
counts the launch in ``launches``.  ``matmul_plain`` is the same function in
plain PyTorch (fp32 product, cast to ``a.dtype`` — ``ref.matmul_ref``); it
serves CPU tensors and is what the card's result is held against.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "matmul.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches made through ``matmul_cuda`` (reset it to 0 to count a run).
launches = 0

_ENTRY = {torch.float32: "repro_matmul_f32",
          torch.bfloat16: "repro_matmul_bf16"}


@dataclasses.dataclass(frozen=True)
class Library:
    """The loaded kernel library and how it was built."""

    cdll: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float      # 0.0 when an up-to-date build was reused
    log: str                  # nvcc / ptxas report of the build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build ``csrc/matmul.cu`` (once per source hash) and load it."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libmatmul-{tag}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode:
            raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{log}")
        os.replace(tmp, so)
    cdll = ctypes.CDLL(str(so))
    for name in _ENTRY.values():
        fn = getattr(cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return Library(cdll, so, seconds, log)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """Shape/dtype contract shared by the kernel and its plain version:
    (M, K) @ (K, N), or (B, M, K) @ (B, K, N), both f32 or both bf16."""
    if a.dtype != b.dtype or a.dtype not in _ENTRY:
        raise TypeError(f"matmul takes two float32 or two bfloat16 "
                        f"operands, got {a.dtype} and {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"matmul takes (M, K) @ (K, N) or (B, M, K) @ "
                         f"(B, K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul shapes do not match: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 product, output in
    ``a.dtype``.  (On the card, a caller disables TF32 to make this the
    IEEE fp32 product.)"""
    _check(a, b)
    return (a.float() @ b.float()).to(a.dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on ``a @ b`` (contiguous CUDA operands)."""
    global launches
    _check(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul_cuda needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda needs contiguous operands")
    batch = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    N = b.shape[-1]
    if batch > 65535 or (M + 127) // 128 > 65535 or max(M, N, K) >= 2**31:
        raise ValueError(f"matmul_cuda grid limit exceeded by "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    out = torch.empty(tuple(a.shape[:-1]) + (N,), dtype=a.dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    fn = getattr(library().cdll, _ENTRY[a.dtype])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, M, N, K,
                 M * K, K * N, M * N, stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed with CUDA error "
                           f"{err} for {tuple(a.shape)} @ {tuple(b.shape)}")
    launches += 1
    return out
