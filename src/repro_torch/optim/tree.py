"""Leaf-wise helpers over the port's parameter trees: nested dicts and
tuples (the period-grouped ``layers`` stack) of tensors.

Leaves come in ``jax.tree`` order — dict keys sorted, tuples in order — so
a loop over them sums and updates in the reference's order, and any trees
of one structure (params, grads, optimiser moments) line up leaf by leaf.
"""

from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest`` (same
    structure) -> a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(like, values: list):
    """A tree of ``like``'s structure whose leaves, in ``leaves`` order, are
    ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return tuple(build(sub) for sub in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out
