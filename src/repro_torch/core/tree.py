"""Parameter trees: nested dicts with tensor (or any non-dict) leaves.

Leaves come out in the reference's order — ``jax.tree.leaves`` walks a
dict's keys sorted — so a leaf index means the same leaf in both packages
(the step graph's gradient keys, ``zip`` with the ``PMeta`` leaves).
"""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree``, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like, values) -> object:
    """A tree shaped like ``like`` holding ``values`` in ``leaves`` order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            out = {}
            for k in sorted(t):
                out[k] = build(t[k])
            return {k: out[k] for k in t}
        return next(it)

    out = build(like)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} values left over after filling the tree")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
