"""Nested-dict trees of tensors: the slice of ``jax.tree`` the training
modules use.  A tree is a dict whose values are leaves or trees; keys are
visited in sorted order, as JAX flattens a dict."""
from __future__ import annotations

import torch

SEP = "/"


def leaves(tree) -> list:
    """The leaves in flattening order."""
    return list(flatten(tree).values())


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} in flattening order; a path joins the keys with
    :data:`SEP` (the reference's checkpoint names)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + SEP))
        else:
            out[path] = v
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def unflatten(like, flat: dict, prefix: str = ""):
    """A tree of ``like``'s structure holding ``flat``'s leaves by path."""
    return {k: unflatten(v, flat, f"{prefix}{k}{SEP}")
            if isinstance(v, dict) else flat[f"{prefix}{k}"]
            for k, v in like.items()}


def unstack(tree, n: int) -> list:
    """Slices 0..n-1 of every tensor of ``tree`` along its leading axis, as
    n trees of views.  One ``unbind`` a tensor: its backward stacks the
    slices' gradients in one pass, where n separate selects would each
    add a zero-filled gradient of the whole tensor."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = v.unbind(0) if isinstance(v, torch.Tensor) else unstack(v, n)
        for j in range(n):
            out[j][k] = parts[j]
    return out
