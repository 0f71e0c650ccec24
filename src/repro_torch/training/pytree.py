"""Param trees in JAX's flatten order.

The port's params are the JAX pytree's layout (nested dicts and lists of
tensors), plus one derived entry, ``unembed_f32`` (the fp32 unembedding
made at load, ``models/model.py::add_unembed_f32``), which is no param:
it is left out here, as ``bridge.to_numpy`` leaves it out.  JAX flattens
a dict by its sorted keys and a list in order; the optimizer's state and
the checkpoint's ``a{i}`` arrays follow that order.
"""
from __future__ import annotations

DERIVED = ("unembed_f32",)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order (derived entries left out)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) if k not in DERIVED
                for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree shaped like ``like`` (derived entries left out) holding
    ``leaves`` in JAX's order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t) if k not in DERIVED}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree) -> object:
    """``fn`` applied to every leaf, in a tree of the same layout."""
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def treedef_str(tree) -> str:
    """The tree's structure as JAX prints its ``PyTreeDef``:
    ``PyTreeDef({'a': *, 'b': [*, *]})``."""
    def show(t):
        if isinstance(t, dict):
            keys = [k for k in sorted(t) if k not in DERIVED]
            return "{" + ", ".join(f"{k!r}: {show(t[k])}" for k in keys) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(show(v) for v in t) + "]"
        return "*"

    return f"PyTreeDef({show(tree)})"
