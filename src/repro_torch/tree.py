"""Parameter trees: nested dicts, lists and tuples of tensors.

The JAX package walks its parameter and optimizer trees with
``jax.tree_util``; the port keeps the same trees (dicts of tensors, lists
of layers, NamedTuple states) and walks them here.  Dict keys are visited
in sorted order, as ``jax.tree_util`` visits them, so a flattened tree
lists its leaves in the same order in both packages; ``None`` is an empty
subtree there and here (a plain MLP's absent ``w_gate``).
"""

from __future__ import annotations

from typing import Any, Callable


def _children(node, is_leaf):
    if is_leaf is not None and is_leaf(node):
        return None
    if node is None:
        return []
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    """The tree's leaves in visiting order."""
    out = []

    def walk(node):
        kids = _children(node, is_leaf)
        if kids is None:
            out.append(node)
        else:
            for k in kids:
                walk(k)

    walk(tree)
    return out


def unflatten(template, values, is_leaf=None):
    """A tree shaped like ``template`` whose leaves are ``values`` (in
    ``leaves`` order)."""
    it = iter(values)

    def build(node):
        if _children(node, is_leaf) is None:
            return next(it)
        if node is None:
            return None
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        kids = [build(v) for v in node]
        if hasattr(node, "_fields"):          # NamedTuple
            return type(node)(*kids)
        return type(node)(kids)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over corresponding leaves of trees of one structure."""
    cols = [leaves(t, is_leaf) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)], is_leaf)
