"""Nested parameter trees (dicts and lists of tensors): the port's stand-in
for ``jax.tree``.  Dict keys are walked in sorted order, so two trees of
the same structure yield their leaves in the same order."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree`` (anything that is not a dict, list or tuple)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from tree_leaves(item)
    else:
        yield tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; dicts stay dicts, lists and tuples become lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in the order
    :func:`tree_leaves` walks ``tree``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        return next(it)

    return build(tree)
