"""Shared optimizer construction for algorithm learners.

The reference chains optax transforms (`ray_tpu/rllib/utils/optim.py`). The
port has a functional optimizer with optax's semantics over the same param
trees of tensors, so every `_make_learner` keeps its shape:
`opt.init(params) -> state`, `opt.update(grads, state, params) -> (updates,
state)`, `apply_updates(params, updates)`. Each transform computes what
optax's does, in the same order:

- `clip_by_global_norm`: g · max_norm / ‖g‖ only when ‖g‖ >= max_norm
  (not `clip_grad_norm_`'s max_norm / (‖g‖ + 1e-6));
- `adam`: optax's `scale_by_adam` (bias corrections 1 - b**t in f32) then
  the learning rate;
- `rmsprop`: optax's `scale_by_rms`: g · rsqrt(ν + eps), eps inside the
  root, ν starting at 0 (not `torch.optim.RMSprop`'s g / (√ν + eps)).

`value_and_grad(loss_fn)` is `jax.value_and_grad(loss_fn, has_aux=True)`
over such a tree, and `gradient_step` one optimizer step on its gradient:
the step every learner's update takes. `make_minibatch_update` is the
epoch loop of PPO, BC, MARWIL and CQL (the reference's nested `lax.scan`
over permuted minibatches), split into the permutations, drawn from the
learner's generator, and the update given them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .tree import tree_leaves, tree_map, tree_unflatten_like


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32, 0-d
    mu: object
    nu: object


class ScaleByRmsState(NamedTuple):
    nu: object


def _device(tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(updates, state, params=None):
        g_norm = torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(updates)))
        trigger = g_norm < max_norm
        return tree_map(lambda t: torch.where(trigger, t, (t / g_norm) * max_norm), updates), state

    return GradientTransformation(init, update)


def _scale(step_size: float) -> Callable:
    return lambda updates: tree_map(lambda g: step_size * g, updates)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=_device(params)),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update(updates, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g ** 2) + b2 * t, updates, state.nu)
        count = state.count + 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** count
        out = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return _scale(-lr)(out), ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByRmsState(nu=tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        nu = tree_map(lambda g, t: (1 - decay) * (g ** 2) + decay * t, updates, state.nu)
        out = tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, updates)
        return _scale(-lr)(out), ScaleByRmsState(nu=nu)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def value_and_grad(loss_fn: Callable) -> Callable:
    """`fn(params, *args) -> (aux, grads)` for `loss_fn(params, *args) ->
    (loss, aux)`: the reference's `jax.value_and_grad(loss_fn,
    has_aux=True)` (aux detached); a leaf the loss does not use gets a zero
    gradient."""
    def fn(params, *args):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        total, aux = loss_fn(tree_unflatten_like(params, leaves), *args)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in aux.items()}, tree_unflatten_like(params, grads)

    return fn


def gradient_step(opt: GradientTransformation, value_and_grad: Callable, state, *args):
    """One step of `opt` on the gradient of `value_and_grad(params, *args)`:
    ((params, opt_state), aux), state being (params, opt_state)."""
    params, opt_state = state
    aux, grads = value_and_grad(params, *args)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    return (params, opt_state), aux


def minibatch_perms(gen: torch.Generator, N: int, num_epochs: int, num_minibatches: int,
                    mb_size: int) -> torch.Tensor:
    """[num_epochs, num_minibatches, mb_size] int64 sample indices on the
    generator's device: one permutation of N per epoch, truncated so uneven
    batches still tile into equal-size minibatches (a few samples dropped
    per epoch), as the reference's `jax.random.permutation` per epoch key."""
    return torch.stack([
        torch.randperm(N, generator=gen, device=gen.device)[: num_minibatches * mb_size]
        .reshape(num_minibatches, mb_size)
        for _ in range(num_epochs)
    ])


def minibatch_sgd(step: Callable, state, batch, perms):
    """Epochs of minibatch steps over `perms` ([num_epochs, num_minibatches,
    mb_size] sample indices): `step(state, mb) -> (state, aux)` per
    minibatch, in order. Metrics averaged over every minibatch (the
    reference's nested `lax.scan`, `jnp.mean` over both axes), on the
    device, once."""
    auxs = []
    for epoch in perms:
        for idx in epoch:
            state, aux = step(state, {k: v[idx] for k, v in batch.items()})
            auxs.append(aux)
    return state, {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def make_minibatch_update(step: Callable, num_epochs: int, minibatch_size: int,
                          prepare: Callable = None) -> Callable:
    """update(state, batch, gen) -> (state, metrics): `num_epochs` epochs of
    `step` over minibatches of min(minibatch_size, N) samples, one
    permutation per epoch drawn from `gen`; and `update.with_perms(state,
    batch, perms)`, the same update given the permutations. `prepare(state,
    batch)`, when given, turns the batch into per-sample rows first, without
    gradients (PPO's GAE); else the batch's rows are the samples."""
    def samples(state, batch):
        if prepare is None:
            return batch
        with torch.no_grad():
            return prepare(state, batch)

    def with_perms(state, batch, perms):
        return minibatch_sgd(step, state, samples(state, batch), perms)

    def update(state, batch, gen):
        flat = samples(state, batch)
        N = flat["obs"].shape[0]
        mb_size = min(minibatch_size, N)
        perms = minibatch_perms(gen, N, num_epochs, max(N // mb_size, 1), mb_size)
        return minibatch_sgd(step, state, flat, perms)

    update.with_perms = with_perms
    return update


def make_optimizer(cfg, kind: str = "adam"):
    """grad-clip (when configured) chained onto the base optimizer — the
    block every `_make_learner` needs."""
    chain_ = []
    if cfg.grad_clip is not None:
        chain_.append(clip_by_global_norm(cfg.grad_clip))
    if kind == "adam":
        chain_.append(adam(cfg.lr))
    elif kind == "rmsprop":
        chain_.append(rmsprop(cfg.lr, decay=0.99, eps=0.1))
    else:
        raise ValueError(f"unknown optimizer kind {kind!r}")
    return chain(*chain_)
