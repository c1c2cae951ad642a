"""Pytree helpers over dict, list, tuple and NamedTuple, in JAX's leaf order.

JAX flattens a dict in **sorted-key** order; ``torch.utils._pytree`` keeps
insertion order.  Per-leaf radii, the payload list and the per-leaf moment
sums all follow the leaf order, so the port flattens exactly like
``jax.tree_util``: sorted dict keys, list/tuple positions, NamedTuple field
order, ``None`` as an empty subtree.  Everything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


class SharedIterates(list):
    """A list of references to iterates (parameter trees) that their
    holders never update in place, so that several slots may hold one
    tree: the stale iterates ``theta_last`` of the lazy rules, the SVRG
    anchors ``theta_anchor`` and the ``delay`` participation ring.  It
    flattens as a list; a checkpoint load
    (:func:`repro_torch.checkpoint.ckpt.load_checkpoint`) gives its rows
    back as one tensor per distinct iterate, shared by every slot that
    held it."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(node, leaves: list):
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), tuple(_flatten(node[k], leaves)
                                           for k in keys))
    if _is_namedtuple(node):
        return ("namedtuple", type(node), tuple(_flatten(c, leaves)
                                                for c in node))
    if isinstance(node, (list, tuple)):
        return (type(node), None, tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return ("leaf",)


def _unflatten(d, it):
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(d[1], d[2])}
    if kind == "namedtuple":
        return d[1](*[_unflatten(c, it) for c in d[2]])
    return kind(_unflatten(c, it) for c in d[2])


def tree_flatten(tree) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the tree in
    :func:`tree_unflatten`.  (Module-level recursion, not a recursive
    closure: a closure that calls itself is a reference cycle, and the
    cycle would keep the leaves alive until the garbage collector runs.)"""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and each of ``rest``
    (same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree structures differ: {len(leaves)} vs "
                             f"{len(o)} leaves")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
