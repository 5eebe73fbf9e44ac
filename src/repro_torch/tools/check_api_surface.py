"""API-surface check: the port's collectives go through ``repro_torch.comm``.

The reference's ``scripts/check_api_surface.py`` over the port's package
(``src/repro_torch``).  Fails (exit 1) on four kinds of bypass:

1. **Raw tier kwargs** — a module outside ``comm/`` and ``substrate/``
   passing ``fast_axis=`` / ``slow_axis=`` keyword arguments, the
   free-function calling convention the ``Communicator`` replaced.
2. **Raw substrate collectives** — ``all_gather`` / ``psum`` /
   ``psum_scatter`` / ``pmax`` / ``all_to_all`` / ``ppermute`` of
   ``substrate.collectives`` called (as ``coll.<op>(`` or
   ``collectives.<op>(``, or imported by name) outside ``comm/``,
   ``substrate/`` and ``kernels/``.  A raw collective bypasses scheme
   dispatch and the step-graph optimizer (``Communicator.record()`` cannot
   bucket a collective it never sees).  Known-legitimate sites carry the
   reference's inline ``# raw-collective: <reason>`` pragma, on the line
   or the line above — the tp fast paths of ``models/parallel.py`` (the
   single flat tp group has one schedule), the sync primitives of
   ``core/sync.py`` the machinery is built from, SUMMA's pedagogical raw
   baseline and the serving bench's liveness checksums, as in the
   reference.
3. **Deprecated compression free functions** — ``int8_bridge_psum(``
   outside ``comm/`` and ``optim/``: new call sites go through
   ``Communicator.allreduce(..., precision="lossy")``.
4. **Bare ``Communicator(...)`` in the rebuild paths** — ``runtime/`` and
   ``launch/`` construct communicators only through
   ``Communicator.from_cluster`` / ``from_topology``, whose static
   pods / chips counts keep the tuning signature resolvable after an
   elastic rebuild.

Allowed everywhere: ``VirtualCluster(...)`` (the substrate's topology
spec is where axis names live; the substrate's own ``cls(...)`` is inside
``substrate/``), ``Communicator(...)`` outside the rebuild paths, and
annotated fields (``fast_axis: Axis = "data"``), which never match the
kwarg pattern.  Grep-based by design (no imports, no AST).

    python -m repro_torch.tools.check_api_surface [package_root]
"""

from __future__ import annotations

import pathlib
import re
import sys

PACKAGE = pathlib.Path(__file__).resolve().parent.parent

KWARG_RE = re.compile(r"\b(?:fast_axis|slow_axis)\s*=(?!=)")
ALLOWED_LINE_RE = re.compile(r"\b(?:VirtualCluster|Communicator)\s*\(")
KWARG_ALLOWED_PATHS = ("comm/", "substrate/")

OPS = r"(?:all_gather|psum|psum_scatter|pmax|all_to_all|ppermute)"
RAW_RE = re.compile(rf"\b(?:coll|collectives)\.{OPS}\s*\(")
RAW_IMPORT_RE = re.compile(
    rf"\bfrom\s+repro_torch\.substrate\.collectives\s+import\b.*\b{OPS}\b")
RAW_PRAGMA = "raw-collective:"
RAW_ALLOWED_PATHS = ("comm/", "substrate/", "kernels/")

DEPRECATED_RE = re.compile(r"\bint8_bridge_psum\s*\(")
DEPRECATED_ALLOWED_PATHS = ("comm/", "optim/")

# a bare constructor: ``Communicator(`` or ``comm.Communicator(``, but not
# the classmethods ``Communicator.from_cluster(`` / ``.from_topology(``
CTOR_RE = re.compile(r"\bCommunicator\s*\(")
CTOR_SCAN_PATHS = ("runtime/", "launch/")


#: this module, whose patterns and docs name what it looks for
SELF = "tools/check_api_surface.py"


def _scan_files(root: pathlib.Path):
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel != SELF:
            yield path, rel


def kwarg_violations(root: pathlib.Path) -> list[str]:
    out: list[str] = []
    for path, rel in _scan_files(root):
        if rel.startswith(KWARG_ALLOWED_PATHS):
            continue
        depth = 0          # open-paren depth of an allowed call: its
        for lineno, line in enumerate(  # continuation lines are allowed
                path.read_text().splitlines(), start=1):
            code = line.split("#", 1)[0]
            m = ALLOWED_LINE_RE.search(code)
            if depth == 0 and m:
                # only the allowed call's own (possibly multi-line)
                # argument list is exempt; text before it and after its
                # same-line close is still checked
                if KWARG_RE.search(code[:m.start()]):
                    out.append(f"{rel}:{lineno}: {line.strip()}")
                d, end = 0, None
                for idx in range(m.start(), len(code)):
                    if code[idx] == "(":
                        d += 1
                    elif code[idx] == ")":
                        d -= 1
                        if d == 0:
                            end = idx + 1
                            break
                if end is None:          # the call continues below
                    depth = d
                    continue
                if KWARG_RE.search(code[end:]) and \
                        not ALLOWED_LINE_RE.search(code[end:]):
                    out.append(f"{rel}:{lineno}: {line.strip()}")
                continue
            if depth > 0:
                depth = max(depth + code.count("(") - code.count(")"), 0)
                continue
            if KWARG_RE.search(code):
                out.append(f"{rel}:{lineno}: {line.strip()}")
    return out


def raw_violations(root: pathlib.Path) -> list[str]:
    """Raw substrate collective call sites (or by-name imports) outside
    the comm layers.  The pragma is read on the full line or the line
    above."""
    out: list[str] = []
    for path, rel in _scan_files(root):
        if rel.startswith(RAW_ALLOWED_PATHS):
            continue
        lines = path.read_text().splitlines()
        for lineno, line in enumerate(lines, start=1):
            if RAW_PRAGMA in line or (
                    lineno >= 2 and RAW_PRAGMA in lines[lineno - 2]):
                continue
            code = line.split("#", 1)[0]
            if RAW_RE.search(code) or RAW_IMPORT_RE.search(code):
                out.append(f"{rel}:{lineno}: {line.strip()}")
    return out


def deprecated_violations(root: pathlib.Path) -> list[str]:
    out: list[str] = []
    for path, rel in _scan_files(root):
        if rel.startswith(DEPRECATED_ALLOWED_PATHS):
            continue
        for lineno, line in enumerate(path.read_text().splitlines(),
                                      start=1):
            if DEPRECATED_RE.search(line.split("#", 1)[0]):
                out.append(f"{rel}:{lineno}: {line.strip()}")
    return out


def ctor_violations(root: pathlib.Path) -> list[str]:
    out: list[str] = []
    for path, rel in _scan_files(root):
        if not rel.startswith(CTOR_SCAN_PATHS):
            continue
        for lineno, line in enumerate(path.read_text().splitlines(),
                                      start=1):
            if CTOR_RE.search(line.split("#", 1)[0]):
                out.append(f"{rel}:{lineno}: {line.strip()}")
    return out


def violations(root: pathlib.Path = PACKAGE) -> list[str]:
    return kwarg_violations(root) + raw_violations(root) \
        + deprecated_violations(root) + ctor_violations(root)


_MESSAGES = (
    (kwarg_violations, "raw fast_axis=/slow_axis= kwargs outside comm/ and "
     "substrate/: route these call sites through repro_torch.comm."
     "Communicator or its SharedWindow"),
    (raw_violations, "raw substrate collectives outside comm/, substrate/ "
     "and kernels/: dispatch through the Communicator (so the scheme "
     "registry and the step-graph optimizer see them), or justify with "
     "an inline '# raw-collective: <reason>' pragma"),
    (deprecated_violations, "deprecated int8_bridge_psum( call sites "
     "outside comm/ and optim/: use Communicator.allreduce(..., "
     "precision='lossy')"),
    (ctor_violations, "bare Communicator(...) in runtime/ or launch/: use "
     "Communicator.from_cluster / from_topology so the static pods/chips "
     "counts survive elastic rebuilds"),
)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    root = pathlib.Path(args[0]) if args else PACKAGE
    failed = False
    for check, what in _MESSAGES:
        bad = check(root)
        if bad:
            failed = True
            print(f"api-surface check FAILED: {what}:", file=sys.stderr)
            for v in bad:
                print(f"  {v}", file=sys.stderr)
    if failed:
        return 1
    print("api-surface check OK: every collective call site of the port "
          "goes through repro_torch.comm")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
