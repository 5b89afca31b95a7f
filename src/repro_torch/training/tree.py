"""Trees of tensors: flatten in the JAX package's order, map, rebuild,
and differentiate.

A tree is nested dicts (keys taken in sorted order), NamedTuples (fields
in order), tuples and lists, with tensors (or anything else that is none
of those) as leaves and ``None`` as an empty subtree — the order and the
path strings of ``jax.tree_util.tree_flatten_with_path``: ``['key']`` for
a dict key, ``.field`` for a NamedTuple field, ``[i]`` for a sequence
index.  So a checkpoint's manifest names the same leaves in both packages.
"""

from __future__ import annotations

import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_paths(tree) -> list[tuple[str, object]]:
    """``[(path, leaf)]`` in flatten order; ``path`` joins the keys with
    ``/`` as the JAX package's checkpoints do."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], (*path, f"[{k!r}]"))
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), (*path, f".{f}"))
        elif isinstance(node, (tuple, list)):
            for i, x in enumerate(node):
                walk(x, (*path, f"[{i}]"))
        else:
            out.append(("/".join(path), node))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves):
    """``like``'s structure with ``new_leaves`` in flatten order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees shaped like it."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest), strict=True)])


def value_and_grad(fn):
    """``jax.value_and_grad`` for a function of a tree of tensors: returns
    ``g(params, *args) -> (value, grads)`` with ``grads`` shaped like
    ``params``.  A floating-point leaf the value does not depend on gets a
    zero gradient, as in JAX; other leaves get ``None``."""

    def wrapped(params, *args, **kwargs):
        flat = [x.detach().requires_grad_(x.is_floating_point())
                for x in leaves(params)]
        value = fn(unflatten(params, flat), *args, **kwargs)
        diff = [x for x in flat if x.requires_grad]
        grads = iter(torch.autograd.grad(value, diff, allow_unused=True))
        out = []
        for x in flat:
            g = next(grads) if x.requires_grad else None
            out.append(torch.zeros_like(x) if g is None and x.requires_grad
                       else g)
        return value.detach(), unflatten(params, out)

    return wrapped
