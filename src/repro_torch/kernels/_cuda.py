"""One builder for every CUDA source of the port.

Each kernel is a ``csrc/<name>.cu`` file with a plain C interface.  At first
use ``nvcc`` builds it for ``sm_90a`` into a shared library under ``_build/``
beside the package, named by the source's stem and a hash of its bytes and
of every ``csrc/*.cuh`` header it may include (an edited source or header
builds anew; an up-to-date build is reused), and ``ctypes`` loads it.
The kernel modules set their own entry points' ``argtypes``.
``build_all`` starts one ``nvcc`` per source at once.  ``DeviceCounter`` is
a count that kernels keep on the card (the non-finite rule's recomputes).
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
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("matmul.cu", "q4_matmul.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "lru_scan.cu", "lru_scan_bwd.cu",
           "moe_gather.cu")


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it was built."""

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
                       f"the kernels in {CSRC}")


def tag(source: str) -> str:
    """The build's name: a hash of ``csrc/<source>`` and of every
    ``csrc/*.cuh`` header (name and bytes)."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library(source: str) -> Library:
    """Build ``csrc/<source>`` (once per hash of it and the headers) and
    load it."""
    src = CSRC / source
    so = BUILD_DIR / f"lib{src.stem}-{tag(source)}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode:
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, so)
    return Library(ctypes.CDLL(str(so)), so, seconds, log)


def build_all() -> dict[str, Library]:
    """Build every source of ``SOURCES`` concurrently (one ``nvcc`` each)."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(library, SOURCES)))


class DeviceCounter:
    """One int32 count on each CUDA device that kernels add to with
    ``atomicAdd``: ``buffer(device)`` is what a launch passes, ``read()``
    sums the devices' counts (a device-to-host copy each, which waits for
    the launches before it) and ``reset()`` sets them to 0."""

    def __init__(self):
        self._bufs: dict[int, torch.Tensor] = {}

    def buffer(self, device: torch.device) -> torch.Tensor:
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        buf = self._bufs.get(index)
        if buf is None:
            buf = torch.zeros(1, dtype=torch.int32,
                              device=torch.device("cuda", index))
            torch.cuda.synchronize(buf.device)   # zeroed before any stream
            self._bufs[index] = buf              # adds to it
        return buf

    def read(self) -> int:
        return sum(int(b.item()) for b in self._bufs.values())

    def reset(self) -> None:
        for b in self._bufs.values():
            b.zero_()
