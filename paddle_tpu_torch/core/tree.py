"""Leaves of nested parameter containers in ``jax.tree.leaves`` order.

The JAX package walks its parameter and optimizer pytrees with
``jax.tree``: dict keys sorted, lists and tuples in order, recursively.
The port keeps the same order, so a slot list built from
:func:`leaves` lines up, position by position, with the JAX package's
``init_tree`` state."""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` (nested dicts, lists and tuples); dict keys
    are visited in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, values) -> object:
    """A tree shaped as ``like`` holding ``values`` (in :func:`leaves`
    order) at its leaves."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}   # the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
