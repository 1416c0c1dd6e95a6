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
epoch loop of PPO, BC, MARWIL, CQL and DT (the reference's nested
`lax.scan` over permuted minibatches), split into the permutations, drawn
from the learner's generator, and the update given them. `step_program` is
the scan of those minibatch steps and of DQN's, SAC's, TD3's, DDPG's and
DreamerV3's gradient steps, and runs A2C's, IMPALA's and APPO's single step:
on the card each step is one CUDA graph (`GraphedSteps`), replayed once a
step.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, NamedTuple, Optional, Sequence

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
    """optax's adam, each op over every leaf at once (`torch._foreach_*`:
    one launch for a list of tensors on the card; the same arithmetic, op
    for op, as a loop over the leaves)."""
    def init(params):
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=_device(params)),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update(updates, state, params=None):
        g, m, v = tree_leaves(updates), tree_leaves(state.mu), tree_leaves(state.nu)
        # (1 - b1)·g + b1·mu and (1 - b2)·g² + b2·nu
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(m, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2), torch._foreach_mul(v, b2))
        count = state.count + 1
        # torch.full, not torch.tensor: a fill kernel, so a CUDA graph can capture it.
        bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=count.device) ** count
        bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=count.device) ** count
        # -lr · (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        out = torch._foreach_mul(torch._foreach_div(torch._foreach_div(mu, bc1), denom), -lr)
        return tree_unflatten_like(updates, out), ScaleByAdamState(
            count=count, mu=tree_unflatten_like(updates, mu), nu=tree_unflatten_like(updates, nu))

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
    leaves = tree_leaves(params)
    summed = torch._foreach_add(leaves, tree_leaves(updates))
    return tree_unflatten_like(params, [s.to(p.dtype) for p, s in zip(leaves, summed)])


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


def _mean_aux(auxs: list) -> dict:
    """Each metric averaged over the steps, on the device (the reference's
    `jax.tree.map(lambda x: x.mean(), auxs)`)."""
    return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


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


def minibatch_sgd(program: Callable, state, batch, perms):
    """Epochs of minibatch steps over `perms` ([num_epochs, num_minibatches,
    mb_size] sample indices), in order: the minibatches gathered at once
    ([num_epochs · num_minibatches, mb_size, ...]) and run by `program` (a
    `step_program` of the minibatch step). Metrics averaged over every
    minibatch (the reference's nested `lax.scan`, `jnp.mean` over both
    axes), on the device, once."""
    idx = perms.reshape(-1, perms.shape[-1])
    return program(state, {k: v[idx] for k, v in batch.items()}, [None] * idx.shape[0])


def make_minibatch_update(step: Callable, num_epochs: int, minibatch_size: int,
                          prepare: Callable = None) -> Callable:
    """update(state, batch, gen) -> (state, metrics): `num_epochs` epochs of
    `step` over minibatches of min(minibatch_size, N) samples, one
    permutation per epoch drawn from `gen`; `update.with_perms(state,
    batch, perms)`, the same update given the permutations; and
    `update.perms(gen, N)`, the permutations it draws for N samples.
    `prepare(state, batch)`, when given, turns the batch into per-sample
    rows first, without gradients (PPO's GAE); else the batch's rows are
    the samples. On the card each minibatch step replays one CUDA graph
    (`step_program`)."""
    program = step_program(lambda st, mb, _: step(st, mb))

    def samples(state, batch):
        if prepare is None:
            return batch
        with torch.no_grad():
            return prepare(state, batch)

    def with_perms(state, batch, perms):
        return minibatch_sgd(program, state, samples(state, batch), perms)

    def perms(gen, N):
        mb_size = min(minibatch_size, N)
        return minibatch_perms(gen, N, num_epochs, max(N // mb_size, 1), mb_size)

    def update(state, batch, gen):
        flat = samples(state, batch)
        return minibatch_sgd(program, state, flat, perms(gen, flat["obs"].shape[0]))

    update.with_perms = with_perms
    update.perms = perms
    return update


@contextlib.contextmanager
def graph_capture(graph):
    """`torch.cuda.graph(graph)` with Python's cyclic garbage collector off.
    A CUDA graph left in a dead reference cycle (an earlier learner's, or an
    earlier algorithm's) and collected in the middle of a capture is
    destroyed there, and destroying a graph while a stream captures
    invalidates the capture (cudaErrorStreamCaptureInvalidated)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


class GraphedSteps:
    """The gradient steps of one update, each variant of the step captured
    once as a CUDA graph over one set of static tensors: the state, and the
    inputs of one step (its minibatch and its draws). A replay reads them
    and writes the new state back into them, so each replay advances the
    state it holds, as one iteration of the reference's `lax.scan` carries
    it (`ray_tpu/rllib/algorithms/sac.py:207-208`, `td3.py:185-186`). A
    graph holds no RNG: the draws are inputs. A capture or a replay that
    fails raises; nothing runs eagerly in its place."""

    def __init__(self, step: Callable, state, inputs):
        self._step = step
        self.state = tree_map(lambda t: t.detach().clone(), state)
        self.inputs = tree_map(lambda t: t.detach().clone(), inputs)
        self._graphs: dict = {}

    def _capture(self, variant):
        device = tree_leaves(self.state)[0].device
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            # Lazy set-up (cuBLAS handles and workspaces, autograd) outside the
            # capture. The step is a function of its arguments: the state is
            # left as it was.
            for _ in range(3):
                self._step(self.state, self.inputs, variant)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph):
            new, aux = self._step(self.state, self.inputs, variant)
            moved = [(static, out) for static, out in zip(tree_leaves(self.state), tree_leaves(new))
                     if out is not static]
            torch._foreach_copy_([static for static, _ in moved], [out for _, out in moved])
            names = list(aux)
            vec = torch.stack([aux[k] for k in names])
        self._graphs[variant] = (graph, names, vec)

    def run(self, state, inputs, variants: Sequence):
        """Step i on row i of `inputs` (a tree of [k, ...] tensors shaped
        as the captured inputs' rows), in `variants[i]`'s graph: the state
        after the k steps (new tensors) and each step's aux."""
        torch._foreach_copy_(tree_leaves(self.state), tree_leaves(state))
        statics, rows = tree_leaves(self.inputs), tree_leaves(inputs)
        auxs = []
        for i, variant in enumerate(variants):
            if variant not in self._graphs:
                self._capture(variant)
            for static, x in zip(statics, rows):
                static.copy_(x[i])
            graph, names, vec = self._graphs[variant]
            graph.replay()
            out = vec.clone()
            auxs.append({k: out[j] for j, k in enumerate(names)})
        return tree_map(torch.clone, self.state), auxs


def scan_steps(step: Callable, state, inputs, variants: Sequence, graphs: Optional[GraphedSteps] = None):
    """The reference's `lax.scan` of gradient steps: `step(state, inputs_i,
    variant) -> (state, aux)` on row i of `inputs` (a tree of [k, ...]
    tensors) in order, in `graphs` when given, else eagerly. Returns (state,
    each metric averaged over the k steps)."""
    if graphs is not None:
        state, auxs = graphs.run(state, inputs, variants)
        return state, _mean_aux(auxs)
    auxs = []
    for i, variant in enumerate(variants):
        state, aux = step(state, tree_map(lambda x: x[i], inputs), variant)
        auxs.append(aux)
    return state, _mean_aux(auxs)


def step_program(step: Callable) -> Callable:
    """`run(state, inputs, variants) -> (state, metrics)`: `scan_steps` of
    `step`. On a CUDA device the steps replay CUDA graphs (`GraphedSteps`,
    captured at the first call for the state's and a row's shapes and
    kept); on the CPU they run eagerly."""
    cache: dict = {}

    def run(state, inputs, variants):
        leaves = tree_leaves(state)
        if leaves[0].device.type != "cuda":
            return scan_steps(step, state, inputs, variants)
        key = (leaves[0].device, tuple((t.shape, t.dtype) for t in leaves),
               tuple((x.shape[1:], x.dtype) for x in tree_leaves(inputs)))
        if key not in cache:
            cache[key] = GraphedSteps(step, state, tree_map(lambda x: x[0], inputs))
        return scan_steps(step, state, inputs, variants, cache[key])

    return run


def single_step_update(step: Callable, keys: Sequence[str]) -> Callable:
    """`update(state, batch, gen) -> (state, metrics)`: one gradient step
    `step(state, batch) -> (state, aux)` on the batch's `keys` fields (the
    fields the step reads: a graph's inputs keep their shapes, and a
    batch's episode stats vary in length), through `step_program`: one CUDA
    graph on the card, eager on the CPU; the update draws nothing."""
    program = step_program(lambda st, b, _: step(st, b))

    def update(state, batch, gen):
        del gen
        return program(state, {k: batch[k][None] for k in keys}, [None])

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
