"""Nested dicts of tensors ("trees"), walked in the reference's leaf order.

The JAX package flattens its parameter and optimizer trees with
``jax.tree_util``: dict keys in sorted order, list and tuple items by
index, ``None`` subtrees skipped. Leaf names join the path's keys with dots
(``repro.checkpoint.store._leaf_name``), e.g. ``m.dense_stack.attn.wq.q``.
Gradient buckets, checkpoints and the bridge all depend on that order and
those names, so the port walks its trees the same way here.
"""

from __future__ import annotations

from typing import Callable


def named_leaves(tree, prefix: str = "", is_leaf: Callable | None = None
                 ) -> list[tuple[str, object]]:
    """``(name, leaf)`` pairs in the reference's flatten order; a subtree
    for which ``is_leaf`` is true counts as one leaf."""
    out: list[tuple[str, object]] = []
    if tree is None:
        return out
    if is_leaf is not None and is_leaf(tree):
        return [(prefix or "root", tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix or "root", tree)]
    for key, sub in items:
        out += named_leaves(sub, f"{prefix}.{key}" if prefix else key,
                            is_leaf)
    return out


def leaves(tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in named_leaves(tree, is_leaf=is_leaf)]


def unflatten(template, new_leaves, is_leaf: Callable | None = None):
    """A tree shaped like ``template`` holding ``new_leaves`` (in
    :func:`named_leaves` order); ``None`` subtrees stay ``None``."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}        # keep the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and ``rest``."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
