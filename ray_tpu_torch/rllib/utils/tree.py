"""Pytree helpers for the RL library's param and optimizer-state trees.

The reference keeps params as JAX pytrees (`{"pi": [{"w", "b"}, ...], "v":
..., "log_std"}`) and walks them with `jax.tree.map` / `jax.tree.leaves`. The
port keeps the same trees of torch tensors and walks them here: dicts (keys
in sorted order, as `jax.tree_util` flattens them), lists, tuples and named
tuples are nodes; `None` is an empty subtree; anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and of each tree in `rest` (same
    structure), as `jax.tree.map`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in `jax.tree.leaves`'s order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten_like(tree, leaves: List[Any]):
    """`tree`'s structure with `leaves` (in `tree_leaves` order) put in."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def to_device(tree, device):
    """Numpy arrays or tensors -> tensors on `device` (a tensor already there
    is not copied; a read-only array, such as one the object store hands
    out, is copied first: a tensor over it could be written)."""
    def leaf(x):
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()
        return torch.as_tensor(x, device=device)

    return tree_map(leaf, tree)


def to_numpy(tree):
    """Tensors -> numpy arrays on the host (the reference's
    `jax.device_get`)."""
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else np.asarray(x), tree)
