"""Parameter trees: nested dicts, tuples, lists and NamedTuples of tensors.

The leaf order is the reference's (`jax.tree.flatten`): dict keys sorted,
tuples and lists in order, NamedTuples in field order, None holds no leaf.
Checkpoints store leaves in this order, so the port and the JAX package
read each other's files.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef); `unflatten(treedef, leaves)` rebuilds the tree."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if _is_namedtuple(t):
            return ("namedtuple", type(t), tuple(walk(c) for c in t))
        if isinstance(t, (tuple, list)):
            return (type(t).__name__, tuple(walk(c) for c in t))
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "namedtuple":
            return d[1](*(build(c) for c in d[2]))
        children = [build(c) for c in d[1]]
        return tuple(children) if kind == "tuple" else children

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def treedef_str(treedef) -> str:
    """The structure as `str(jax.tree.structure(...))` prints it."""

    def fmt(d):
        kind = d[0]
        if kind == "none":
            return "None"
        if kind == "leaf":
            return "*"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(c)}"
                                   for k, c in zip(d[1], d[2])) + "}"
        if kind == "namedtuple":
            return (f"CustomNode(namedtuple[{d[1].__name__}], ["
                    + ", ".join(fmt(c) for c in d[2]) + "])")
        inner = ", ".join(fmt(c) for c in d[1])
        if kind == "tuple":
            return "(" + inner + ("," if len(d[1]) == 1 else "") + ")"
        return "[" + inner + "]"

    return f"PyTreeDef({fmt(treedef)})"


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure, or prefixes holding subtrees at its
    leaves, as `flatten_up_to` reads them)."""
    flat, treedef = flatten(tree)
    others = [flatten_up_to(treedef, r) for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def flatten_up_to(treedef, tree) -> List[Any]:
    """The subtrees of `tree` at the leaf positions of `treedef` (a leaf
    of `treedef` may hold a whole subtree of `tree`, as the 8-bit optimizer
    state holds a dict where the parameter holds a tensor)."""
    out: List[Any] = []

    def walk(d, t):
        kind = d[0]
        if kind == "none":
            return
        if kind == "leaf":
            out.append(t)
        elif kind == "dict":
            if not isinstance(t, dict) or sorted(t) != list(d[1]):
                raise ValueError("tree does not match the structure")
            for k, c in zip(d[1], d[2]):
                walk(c, t[k])
        else:
            children = d[2] if kind == "namedtuple" else d[1]
            if len(t) != len(children):
                raise ValueError("tree does not match the structure")
            for c, x in zip(children, t):
                walk(c, x)

    walk(treedef, tree)
    return out


__all__ = ["flatten", "unflatten", "treedef_str", "leaves", "tree_map",
           "flatten_up_to"]
