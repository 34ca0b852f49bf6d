"""Nested dict/list trees of tensors (the port's stand-in for JAX pytrees).

Leaves are visited as ``jax.tree_util`` visits them: dict keys in sorted
order, lists in index order.  ``keystr`` names a leaf's path as
``jax.tree_util.keystr`` does (``['layers'][0]['ssm']['A_log']``), so a
checkpoint's leaf names are the same in both packages.
"""
from __future__ import annotations


def leaves_with_path(tree, path: str = ""):
    """``[(keystr path, leaf)]`` in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree, new_leaves):
    """``tree``'s structure (dict key order kept) with ``new_leaves``, given
    in :func:`leaves` order, at its leaves."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each leaf."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
