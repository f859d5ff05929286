"""The few pytree operations the training path needs, in
``jax.tree_util``'s leaf order: a dict's values by sorted key, a tuple's
(and a NamedTuple's, such as ``optim.AdamWState``) in field order, a
registered node's children (``register_node``; the sharded tensor's
blocks), and anything else a leaf.  Holding that order makes a global
gradient norm sum its leaves as the reference sums them, and a
checkpoint's leaf i the reference's leaf i.

``is_leaf`` stops the walk at the nodes it accepts (e.g. a sharded
tensor taken whole), as ``jax.tree_util``'s does.  A path is the tuple of
``jax.tree_util``'s key strings down to a leaf: a dict key, a sequence
index, ``.field`` of a NamedTuple.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

# type -> (children of a node, rebuild(node, children))
_NODES: Dict[type, Tuple[Callable, Callable]] = {}


def register_node(cls: type, flatten: Callable, unflatten: Callable) -> None:
    """Walk ``cls`` nodes through ``flatten(node) -> children`` and
    ``unflatten(node, children) -> node``."""
    _NODES[cls] = (flatten, unflatten)


def _children(node, is_leaf) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node, in leaf order; None for a
    leaf."""
    if is_leaf is not None and is_leaf(node):
        return None
    if isinstance(node, dict):
        return [(str(key), node[key]) for key in sorted(node)]
    if isinstance(node, (tuple, list)):
        if hasattr(node, "_fields"):                # a NamedTuple
            return [(f".{f}", v) for f, v in zip(node._fields, node)]
        return [(str(i), v) for i, v in enumerate(node)]
    if type(node) in _NODES:
        return [(str(i), v)
                for i, v in enumerate(_NODES[type(node)][0](node))]
    return None


def tree_leaves_with_path(tree, is_leaf=None) -> List[Tuple[tuple, Any]]:
    """Every (path, leaf) of ``tree`` in ``jax.tree_util`` order."""
    kids = _children(tree, is_leaf)
    if kids is None:
        return [((), tree)]
    return [((key,) + path, leaf) for key, child in kids
            for path, leaf in tree_leaves_with_path(child, is_leaf)]


def tree_leaves(tree, is_leaf=None) -> List[Any]:
    """Every leaf of ``tree`` in ``jax.tree_util`` order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def tree_unflatten(like, leaves, is_leaf=None) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if _children(node, is_leaf) is None:
            return next(it)
        if isinstance(node, dict):
            out = {key: build(node[key]) for key in sorted(node)}
            return {key: out[key] for key in node}
        if isinstance(node, (tuple, list)):
            items = [build(item) for item in node]
            if hasattr(node, "_fields"):            # a NamedTuple
                return type(node)(*items)
            return type(node)(items)
        flatten, unflatten = _NODES[type(node)]
        return unflatten(node, [build(c) for c in flatten(node)])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf=None) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest,
                              is_leaf=is_leaf)


def tree_map_with_path(fn: Callable, tree, *rest, is_leaf=None) -> Any:
    """``fn(path, leaf, *leaves of rest)`` over ``tree``'s leaves and
    the trees of the same structure in ``rest``."""
    pairs = tree_leaves_with_path(tree, is_leaf)
    others = [tree_leaves(t, is_leaf) for t in rest]
    if any(len(o) != len(pairs) for o in others):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(path, x, *(o[i] for o in others))
                                 for i, (path, x) in enumerate(pairs)],
                          is_leaf)


def tree_structure(tree, is_leaf=None) -> str:
    """A description of ``tree``'s structure, ``*`` for each leaf."""
    kids = _children(tree, is_leaf)
    if kids is None:
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {tree_structure(tree[key], is_leaf)}"
                               for key in sorted(tree)) + "}"
    name = type(tree).__name__
    return name + "(" + ", ".join(tree_structure(c, is_leaf)
                                  for _, c in kids) + ")"
