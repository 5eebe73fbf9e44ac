"""Scheme selection: the ``scheme="auto"`` backend.

The paper's central measurement (Figs 7-10) is that the best collective
algorithm depends on topology and message size.  ``resolve()`` is the rule
``Communicator`` consults when ``scheme="auto"``:

1. **modeled**  — the communicator has static ``pods``/``chips`` counts:
   every registry scheme prices the cell with its ``predicted_time`` closed
   form (``core.plans``; ``pipelined`` folds in ``best_chunk_count``) and the
   cheapest allowed scheme wins;
2. **fallback** — no static counts (nothing to model on): the per-family
   defaults of ``FALLBACK`` apply (``LOSSY_FALLBACK`` first under
   ``precision="lossy"``).

``precision`` mirrors ``result_class`` on the exact/lossy axis:
``"exact"`` (the default) never returns a quantized scheme, ``"lossy"``
admits them, capped by ``tol`` (a relative error bound).

No measured table is read yet: the port has no measurement of its own on the
card to fill one.  Resolution is pure Python on static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.comm import registry

#: Per-family defaults when nothing can be modeled (no static pods/chips
#: counts): ``shared`` for the window families, ``hier`` for alltoall;
#: ``naive`` under a ``replicated`` constraint.
FALLBACK = {
    None: {"allgather": "shared", "broadcast": "shared", "psum": "shared",
           "reduce_scatter": "shared", "allgatherv": "shared",
           "alltoall": "hier"},
    "shared": {"allgather": "shared", "broadcast": "shared",
               "psum": "shared", "reduce_scatter": "shared",
               "allgatherv": "shared"},
    "replicated": {"allgather": "naive", "broadcast": "naive",
                   "psum": "naive", "reduce_scatter": "naive",
                   "allgatherv": "naive", "alltoall": "hier"},
}


def topo_signature(pods: int, chips: int, n_fast_axes: int = 1) -> str:
    """Stable topology key: ``{pods}x{chips}`` plus ``-f{n}`` when the fast
    tier spans several named mesh axes."""
    sig = f"{pods}x{chips}"
    if n_fast_axes > 1:
        sig += f"-f{n_fast_axes}"
    return sig


@dataclasses.dataclass(frozen=True)
class Resolution:
    """The outcome of one ``scheme="auto"`` dispatch decision."""

    scheme: str
    opts: dict
    source: str                    # "modeled" | "fallback"


def _usable(sch, family: str, result_class: Optional[str], pods: int,
            chips: int, elems: int, precision: str = "exact",
            tol: Optional[float] = None):
    """The scheme's valid tunable grid for this cell, or ``None`` when the
    caller's result-class / precision constraint or the cell's tiling rules
    it out.  ``precision="exact"`` filters lossy schemes out entirely;
    ``"lossy"`` admits them unless their ``error_bound_rel`` exceeds
    ``tol``."""
    if result_class is not None and sch.result_class != result_class:
        return None
    if sch.precision == "lossy":
        if precision != "lossy":
            return None
        if tol is not None and pods \
                and sch.error_bound_rel(family, pods=pods) > tol:
            return None
    cands = sch.candidates(family, pods=pods, chips=chips, elems=elems)
    return cands or None


def best_scheme_predicted(family: str, *, pods: int, chips: int, elems: int,
                          elem_bytes: int = 4,
                          result_class: Optional[str] = None,
                          precision: str = "exact",
                          tol: Optional[float] = None,
                          populations: Optional[Sequence[int]] = None
                          ) -> Optional[tuple[str, dict, float]]:
    """Model-predicted (scheme, opts, time) for one cell; ties go to the
    first registered scheme."""
    best = None
    for sch in registry.schemes_for(family):
        if _usable(sch, family, result_class, pods, chips, elems,
                   precision, tol) is None:
            continue
        pred = sch.predicted_time(family, pods=pods, chips=chips,
                                  elems=elems, elem_bytes=elem_bytes,
                                  populations=populations)
        if pred is None:
            continue
        t, opts = pred
        if best is None or t < best[2]:
            best = (sch.name, dict(opts), t)
    return best


#: Static-fallback overrides under ``precision="lossy"``: a communicator
#: with no pods/chips counts is all bridge (the gradient-bridge path), so
#: lossy opt-in means "compress that bridge" — the q8 wire format, run
#: single-tier.  Other families keep the exact fallback (lossy *admits*
#: quantized schemes, it never requires one).
LOSSY_FALLBACK = {"psum": "q8_hier", "allgather": "q8_hier"}


def resolve(family: str, *, pods: Optional[int], chips: Optional[int],
            elems: int, elem_bytes: int = 4,
            result_class: Optional[str] = None, precision: str = "exact",
            tol: Optional[float] = None) -> Resolution:
    """Resolve one ``scheme="auto"`` dispatch (modeled -> fallback).
    ``result_class`` constrains the pick to one result class; ``precision``
    / ``tol`` to exact schemes or admitted lossy ones."""
    if result_class not in (None, "replicated", "shared"):
        raise ValueError(f"bad result constraint {result_class!r}")
    if precision not in ("exact", "lossy"):
        raise ValueError(f"bad precision constraint {precision!r} "
                         "(pick 'exact' or 'lossy')")
    if pods and chips:
        best = best_scheme_predicted(family, pods=pods, chips=chips,
                                     elems=elems, elem_bytes=elem_bytes,
                                     result_class=result_class,
                                     precision=precision, tol=tol)
        if best is not None:
            return Resolution(best[0], best[1], "modeled")
        raise ValueError(
            f"no registered scheme can run {family} with elems={elems} on "
            f"a {pods}x{chips} topology"
            + (f" under result={result_class!r}" if result_class else "")
            + " — every candidate grid is empty (tiling)")
    name = None
    if precision == "lossy":
        cand = LOSSY_FALLBACK.get(family)
        if cand is not None and result_class in (
                None, registry.get_scheme(cand).result_class):
            name = cand
    if name is None:
        try:
            name = FALLBACK[result_class][family]
        except KeyError:
            raise ValueError(
                f"scheme='auto' cannot resolve {family} under "
                f"result={result_class!r} without static pods/chips counts"
            ) from None
    return Resolution(name, {}, "fallback")


def resolve_for(comm, family: str, *, elems: int, elem_bytes: int = 4,
                result_class: Optional[str] = None, precision: str = "exact",
                tol: Optional[float] = None) -> Resolution:
    """``resolve`` keyed by a ``Communicator``'s static structure."""
    return resolve(family, pods=comm.pods, chips=comm.chips, elems=elems,
                   elem_bytes=elem_bytes, result_class=result_class,
                   precision=precision, tol=tol)


def signature_for(comm) -> str:
    """The topology signature of a ``Communicator``."""
    from repro_torch.comm import primitives as p
    if comm.pods is None or comm.chips is None:
        raise ValueError("topology signature needs static pods/chips counts "
                         "— build the communicator via from_cluster/"
                         "from_topology")
    return topo_signature(comm.pods, comm.chips,
                          len(p._axes(comm.fast_axis)))
