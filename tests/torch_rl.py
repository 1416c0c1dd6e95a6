"""Helpers shared by the RL parity tests (`tests/test_torch_rllib_*.py`):
leaf-by-leaf comparison with the reference's trees, optimizers that hand a
jitted update's gradient back as its state, and the permutations the
reference draws from a key."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ray_tpu_torch.rllib.utils import optim
from ray_tpu_torch.rllib.utils.tree import tree_leaves, tree_map


def close(got, want, tol, what=""):
    """Each leaf within tol·(1 + max|want|) of the reference's leaf."""
    got_l = [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x) for x in tree_leaves(got)]
    want_l = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l), (what, len(got_l), len(want_l))
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = np.abs(g.astype(np.float64) - w).max() if w.size else 0.0
        assert err <= tol * (1 + np.abs(w).max()), f"{what} leaf {i}: {err}"


def metrics_close(got: dict, want: dict, tol, what="metrics"):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    close([got[k] for k in sorted(want)], [want[k] for k in sorted(want)], tol, what)


def grads_in_state_jax():
    """An optimizer whose state after an update is the gradient it got (and
    which leaves params alone): reads the reference's gradients out of its
    jitted update."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def grads_in_state_port():
    return optim.GradientTransformation(lambda p: tree_map(torch.zeros_like, p),
                                        lambda g, s, p=None: (tree_map(torch.zeros_like, g), g))


def jax_perms(key, N: int, num_epochs: int, mb_size: int) -> np.ndarray:
    """The permutations the reference's epoch loops draw from `key`: one
    `jax.random.permutation` of N per key of `jax.random.split(key,
    num_epochs)`, truncated to whole minibatches ([num_epochs,
    num_minibatches, mb_size])."""
    mb = min(mb_size, N)
    nmb = max(N // mb, 1)
    return np.stack([np.asarray(jax.random.permutation(k, N)[: nmb * mb]).reshape(nmb, mb)
                     for k in jax.random.split(key, num_epochs)])


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    """The reference's tree (numpy or JAX leaves: a batch, or params such as
    DreamerV3's `{"wm": {"gru": {"wx", "wh", "b"}, ...}, ..., "ret_scale"}`)
    as CPU tensors of the same structure; a 0-d leaf stays 0-d."""
    return tree_map(lambda v: torch.from_numpy(np.array(v)), tree)
