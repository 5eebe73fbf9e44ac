"""The MoE block's row movements as Hopper kernels: bind, launch — and
their plain versions.

The kernels (``csrc/moe_gather.cu``) move rows between token order and
expert order and back, batched over a leading ``b`` (the capacity path's tp
ranks and folded members; 1 for the dropless path), each batch entry
through its own tables.  An index equal to the row count of what it indexes
is the sentinel and reads a zero row.  Four entries (``ENTRIES``), each a
memory-bound row pass:

- ``dispatch``: x (b, N, d), table (b, R) in [0, N] and its inverse inv
  (b, N, k) in [0, R] -> buf (b, R, d), ``buf[r] = x[table[r]]`` (the
  kernel walks inv: each token's row read once, written to its k cells);
- ``combine``: src (b, S, d), g (b, N, k), inv (b, N, k) in [0, S] -> y
  (b, N, d), ``y[t] = sum_j g[t, j] * src[inv[t, j]]`` term by term in
  ascending j;
- ``combine_bwd``: dy (b, N, d), g, inv, src and back (b, S) (each cell's
  slot ``t * k + j``, ``N * k``: empty) -> d_src (b, S, d), the gate times
  dy in the cell each slot reaches and zeros in the empty ones, and d_g
  (b, N, k), ``<dy[t], src[inv[t, j]]>``;
- ``dispatch_bwd``: d_buf (b, S, d), inv -> dx (b, N, d), the unweighted
  ordered sum.

``y``, ``dx`` and ``d_src`` are the plain versions' bit for bit (f32 and
bf16); ``d_g`` is a dot product in a fixed order (run to run the same
bits), held to a float64 one.  The tables are one routing's:
``inv[t, j] = r`` exactly where ``table[r] = t`` and ``back[r] = t * k +
j`` (``moe.dispatch_tables`` / ``segment_tables`` and
``moe.combine_tables`` make them so).

``<entry>_cuda`` checks device, dtype, shape and contiguity, raises on
anything else, launches on the current stream and counts the launch in
``launches[entry]``.  ``<entry>_plain`` is the same function in plain
PyTorch (a gather from a zero-padded copy, the k terms added one by one); it
serves CPU and meta tensors and is what the kernels are held against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda

SOURCE = _cuda.CSRC / "moe_gather.cu"

#: The entries, in the order of a block's forward and backward.
ENTRIES = ("dispatch", "combine", "combine_bwd", "dispatch_bwd")
#: Kernel launches by entry (reset the values to 0 to count a run).
launches = dict.fromkeys(ENTRIES, 0)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ENTRY = {(e, dt): f"repro_moe_{e}_{s}" for e in ENTRIES
          for dt, s in _SUFFIX.items()}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "dispatch": [_P] * 4 + [_L] * 3 + [_I] * 2 + [_P],
    "combine": [_P] * 4 + [_L] * 3 + [_I] * 2 + [_P],
    "combine_bwd": [_P] * 7 + [_L] * 3 + [_I] * 2 + [_P],
    "dispatch_bwd": [_P] * 3 + [_L] * 3 + [_I] * 2 + [_P],
}


@functools.lru_cache(maxsize=None)
def library() -> _cuda.Library:
    """Build ``csrc/moe_gather.cu`` (once per source hash), load it and bind
    its entry points."""
    lib = _cuda.library(SOURCE.name)
    for (entry, _), name in _ENTRY.items():
        fn = getattr(lib.cdll, name)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    return lib


# -- the plain versions ------------------------------------------------------

def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (b, S, d), idx (b, ...) in [0, S] -> (b, ..., d): row ``idx`` of
    each batch entry's x, a zero row for ``S``."""
    b, S, d = x.shape
    pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1).reshape(-1, d)
    off = torch.arange(b, device=x.device).reshape(
        (b,) + (1,) * (idx.dim() - 1)) * (S + 1)
    return pad.index_select(0, (idx + off).reshape(-1)).reshape(
        tuple(idx.shape) + (d,))


def ordered_sum(r: torch.Tensor, w=None) -> torch.Tensor:
    """Sum over the k axis (-2) of r (..., N, k, d), term by term in k
    order (each term times ``w[..., j]`` with a weight (..., N, k))."""
    k = r.shape[-2]
    y = r[..., 0, :] if w is None else r[..., 0, :] * w[..., 0, None]
    for j in range(1, k):
        y = y + (r[..., j, :] if w is None else r[..., j, :] * w[..., j, None])
    return y


def _check(entry: str, rows: torch.Tensor, operands: tuple,
           dtypes=tuple(_SUFFIX)) -> None:
    """The contract an entry's kernel and plain version share: ``rows`` (b,
    n, d) of one of ``dtypes``; each (tensor, shape) of ``operands`` of that
    shape (-1: any size), an index table int64, a float one in ``rows``'
    dtype."""
    if rows.dtype not in dtypes or rows.dim() != 3:
        raise TypeError(f"moe_gather {entry} takes (b, n, d) rows of one of "
                        f"{dtypes}, got {tuple(rows.shape)} {rows.dtype}")
    for t, shape in operands:
        if t.dim() != len(shape) or any(
                want not in (-1, got) for want, got in zip(shape, t.shape)):
            raise ValueError(f"moe_gather {entry}: an operand is "
                             f"{tuple(t.shape)}, want {tuple(shape)} (-1: "
                             f"any) beside rows {tuple(rows.shape)}")
        want = rows.dtype if t.is_floating_point() else torch.int64
        if t.dtype != want:
            raise TypeError(f"moe_gather {entry}: an operand is {t.dtype}, "
                            f"want {want}")


def _check_tables(entry: str, rows: torch.Tensor, inv: torch.Tensor,
                  operands: tuple = (), dtypes=tuple(_SUFFIX)) -> None:
    """``_check`` with inv (b, N, k) first, then ``operands``."""
    _check(entry, rows, ((inv, (rows.shape[0], -1, -1)),), dtypes)
    _check(entry, rows, operands, dtypes)


def _bwd_operands(dy, g, inv, src, back) -> tuple:
    """combine_bwd's operands beside src and inv, with their shapes."""
    b, S, d = src.shape
    return ((g, tuple(inv.shape)), (dy, (b, inv.shape[1], d)),
            (back, (b, S)))


_PLAIN = tuple(_SUFFIX) + (torch.float64,)


def dispatch_plain(x: torch.Tensor, table: torch.Tensor, inv: torch.Tensor
                   ) -> torch.Tensor:
    """x (b, N, d), table (b, R), inv (b, N, k) -> (b, R, d), gathered
    through table."""
    _check("dispatch", x, ((table, (x.shape[0], -1)),
                           (inv, tuple(x.shape[:2]) + (-1,))), _PLAIN)
    return gather_rows(x, table)


def combine_plain(src: torch.Tensor, g: torch.Tensor, inv: torch.Tensor
                  ) -> torch.Tensor:
    """src (b, S, d), g and inv (b, N, k) -> (b, N, d)."""
    _check_tables("combine", src, inv, ((g, tuple(inv.shape)),), _PLAIN)
    return ordered_sum(gather_rows(src, inv), g)


def combine_bwd_plain(dy: torch.Tensor, g: torch.Tensor, inv: torch.Tensor,
                      src: torch.Tensor, back: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """dy (b, N, d), g and inv (b, N, k), src (b, S, d), back (b, S) ->
    (d_src (b, S, d), d_g (b, N, k))."""
    _check_tables("combine_bwd", src, inv, _bwd_operands(dy, g, inv, src,
                                                         back), _PLAIN)
    b, N, k = inv.shape
    d_rows = dy[..., None, :] * g[..., None]
    d_src = gather_rows(d_rows.reshape(b, N * k, -1), back)
    d_g = torch.stack([(dy * r).sum(-1) for r in
                       gather_rows(src, inv).unbind(-2)], -1)
    return d_src, d_g


def dispatch_bwd_plain(d_buf: torch.Tensor, inv: torch.Tensor
                       ) -> torch.Tensor:
    """d_buf (b, S, d), inv (b, N, k) -> (b, N, d)."""
    _check_tables("dispatch_bwd", d_buf, inv, dtypes=_PLAIN)
    return ordered_sum(gather_rows(d_buf, inv))


# -- the kernels -------------------------------------------------------------

def _launch(entry: str, dtype: torch.dtype, device: torch.device,
            tensors: tuple, *ints) -> None:
    """Check ``tensors`` (CUDA, one device, contiguous), launch ``entry``
    on their data and ``ints``, raise on a CUDA error, count the launch."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"moe_gather {entry}_cuda needs every operand on "
                             f"{device}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"moe_gather {entry}_cuda needs contiguous "
                             f"operands")
    fn = getattr(library().cdll, _ENTRY[(entry, dtype)])
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"moe_gather {entry} kernel launch failed with "
                           f"CUDA error {err} at "
                           f"{[tuple(t.shape) for t in tensors]}")
    launches[entry] += 1


def _on_card(entry: str, rows: torch.Tensor, k: int = 1) -> None:
    """The kernels' own limits: CUDA operands, a token's k slots in one
    warp's lanes."""
    if rows.device.type != "cuda":
        raise ValueError(f"moe_gather {entry}_cuda needs CUDA tensors, got "
                         f"{rows.device}")
    if not 1 <= k <= 32:
        raise ValueError(f"moe_gather {entry}_cuda takes 1 <= k <= 32, got "
                         f"{k}")


def dispatch_cuda(x: torch.Tensor, table: torch.Tensor, inv: torch.Tensor
                  ) -> torch.Tensor:
    """Launch ``dispatch``: x (b, N, d), table (b, R), inv (b, N, k) -> buf
    (b, R, d)."""
    _check("dispatch", x, ((table, (x.shape[0], -1)),
                           (inv, tuple(x.shape[:2]) + (-1,))))
    (b, N, d), R, k = x.shape, table.shape[1], inv.shape[-1]
    _on_card("dispatch", x, k)
    buf = torch.empty((b, R, d), dtype=x.dtype, device=x.device)
    if buf.numel():
        _launch("dispatch", x.dtype, x.device, (x, inv, table, buf), b, N, R,
                k, d)
    return buf


def combine_cuda(src: torch.Tensor, g: torch.Tensor, inv: torch.Tensor
                 ) -> torch.Tensor:
    """Launch ``combine``: src (b, S, d), g and inv (b, N, k) -> y (b, N,
    d)."""
    _check_tables("combine", src, inv, ((g, tuple(inv.shape)),))
    (b, S, d), (N, k) = src.shape, inv.shape[1:]
    _on_card("combine", src, k)
    y = torch.empty((b, N, d), dtype=src.dtype, device=src.device)
    if y.numel():
        _launch("combine", src.dtype, src.device, (src, inv, g, y), b, N, S,
                k, d)
    return y


def combine_bwd_cuda(dy: torch.Tensor, g: torch.Tensor, inv: torch.Tensor,
                     src: torch.Tensor, back: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``combine_bwd``: dy (b, N, d), g and inv (b, N, k), src (b, S,
    d), back (b, S) -> (d_src (b, S, d), d_g (b, N, k)), every element of
    both written once."""
    _check_tables("combine_bwd", src, inv,
                  _bwd_operands(dy, g, inv, src, back))
    (b, N, k), (S, d) = inv.shape, src.shape[1:]
    _on_card("combine_bwd", src, k)
    d_src = torch.empty_like(src)
    d_g = torch.empty_like(g)
    if d_src.numel() or d_g.numel():
        _launch("combine_bwd", src.dtype, src.device,
                (dy, g, inv, src, back, d_src, d_g), b, N, S, k, d)
    return d_src, d_g


def dispatch_bwd_cuda(d_buf: torch.Tensor, inv: torch.Tensor
                      ) -> torch.Tensor:
    """Launch ``dispatch_bwd``: d_buf (b, S, d), inv (b, N, k) -> dx (b, N,
    d)."""
    _check_tables("dispatch_bwd", d_buf, inv)
    (b, S, d), (N, k) = d_buf.shape, inv.shape[1:]
    _on_card("dispatch_bwd", d_buf, k)
    dx = torch.empty((b, N, d), dtype=d_buf.dtype, device=d_buf.device)
    if dx.numel():
        _launch("dispatch_bwd", d_buf.dtype, d_buf.device, (d_buf, inv, dx),
                b, N, S, k, d)
    return dx
