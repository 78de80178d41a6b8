"""Nested dicts of tensors as trees: the port's stand-in for the pytree
functions the reference takes from ``jax.tree``.  Only dicts are nodes; a
leaf is anything else.  Leaves are visited in sorted-key order, the order
``jax.tree_util`` flattens a dict in, so that sums over leaves and the
checkpoint layout follow the reference's order."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves at the same path of rest)`` over ``tree``'s dict
    structure; ``rest`` may hold more below a path (what lies there is passed
    whole), as ``treedef.flatten_up_to`` allows."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unzip(tree, n: int) -> tuple:
    """A tree whose leaves are n-tuples as n trees."""
    return tuple(tree_map(lambda leaf, i=i: leaf[i], tree) for i in range(n))


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its own."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_map_with_path(fn, tree, *rest, _path=()):
    """``fn(path, leaf, *leaves at the same path of rest)``, ``path`` the
    tuple of keys down to the leaf (``jax.tree_util.tree_map_with_path``'s
    key path, as strings)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      _path=_path + (k,)) for k in sorted(tree)}
    return fn(_path, tree, *rest)
