"""The few pytree operations the training path needs, in
``jax.tree_util``'s leaf order: a dict's values by sorted key, a tuple's
(and a NamedTuple's, such as ``optim.AdamWState``) in field order, and
anything else a leaf.  Holding that order makes a global gradient norm
sum its leaves as the reference sums them, and a checkpoint's leaf i
the reference's leaf i."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    """Every leaf of ``tree`` in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {key: build(node[key]) for key in sorted(node)}
            return {key: out[key] for key in node}
        if isinstance(node, (tuple, list)):
            items = [build(item) for item in node]
            if hasattr(node, "_fields"):            # a NamedTuple
                return type(node)(*items)
            return type(node)(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(l_) != len(leaves[0]) for l_ in leaves):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def tree_structure(tree) -> str:
    """A description of ``tree``'s structure, ``*`` for each leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {tree_structure(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__
        return name + "(" + ", ".join(tree_structure(t) for t in tree) + ")"
    return "*"
