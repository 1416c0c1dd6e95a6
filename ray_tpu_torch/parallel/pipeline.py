"""Pipeline parallelism inside one program (GPipe schedule): the
counterpart of `ray_tpu/parallel/pipeline.py`.

The reference runs the whole pipeline inside one jit program over the `pp`
mesh axis: each device holds one stage's weights, microbatches flow stage
to stage via `ppermute`, and the backward schedule emerges from jax AD
transposing the forward `lax.scan` (ppermute's transpose is the reverse
ppermute). The port writes the same tick loop eagerly, one rank per stage,
under `spmd.shard_fn`: over the M + S - 1 ticks stage 0 injects microbatch
t, every stage runs `stage_fn` on what it holds, the last stage keeps
microbatch t - (S - 1), and the activations move with the `ppermute`
autograd Function (`collective/ops.py`), so autograd runs the reverse
ppermute in the backward. The result is replicated by a psum over `pp`.

The backward issues collectives, so every rank of `pp` must build the same
autograd graph in the same order: the loop branches only on the tick,
never on the rank. Where the reference selects by stage (`jnp.where` on
`axis_index`), the port selects with `torch.where` on a rank-valued mask,
so a stage's unused inputs (stage 0's received
activation, a non-last stage's outputs) stay in the graph with a zero
cotangent and each rank runs every reverse ppermute its peers run.

Cross-host pipelines over separate programs are the MPMD trainer's
(`train/mpmd`, not ported yet); this in-program GPipe is the baseline its
parity gate measures against.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from .mesh import P, axis_size
from .spmd import shard_fn


def split_microbatches(x, num_microbatches: int):
    """[B, ...] -> [M, B/M, ...]."""
    B = x.shape[0]
    if B % num_microbatches != 0:
        raise ValueError(f"batch {B} not divisible by num_microbatches {num_microbatches}")
    return x.reshape(num_microbatches, B // num_microbatches, *x.shape[1:])


def merge_microbatches(x):
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def stack_stage_params(per_stage_params: list):
    """List of per-stage trees of tensors -> one tree with a leading stage
    axis (shard it P('pp') so each rank holds exactly its stage)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def gpipe_ticks(stage_fn: Callable, x, num_stages: int, axis: str):
    """The GPipe tick loop on this rank (under a bound mesh): x is [M, ...]
    microbatched input (used by stage 0), `stage_fn(act)` -> (act, aux or
    None) runs this rank's stage. Returns (outs [M, ...] on the last stage
    and zeros elsewhere, the list of (tick, aux) of the ticks). Microbatch
    t leaves stage S-1 at tick t + S - 1."""
    from ..collective.ops import axis_index, ppermute

    S, M = num_stages, x.shape[0]
    # The stage-dependent selections go through torch.where on these masks,
    # so every stage builds the same graph.
    s = axis_index(axis)
    is_first, is_last = (torch.tensor(v, device=x.device) for v in (s == 0, s == S - 1))
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    act = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs, auxes = [], []
    for t in range(M + S - 1):
        # Stage 0 injects microbatch t (clamped once the tail drains).
        inp = torch.where(is_first, x[min(t, M - 1)], act)
        y, aux = stage_fn(inp)
        auxes.append((t, aux))
        if t >= S - 1:
            outs.append(torch.where(is_last, y, torch.zeros_like(y)))
        act = ppermute(y, axis, fwd_perm)
    return torch.stack(outs), auxes


def make_gpipe_fn(
    stage_fn: Callable,
    mesh,
    *,
    num_microbatches: int,
    axis: str = "pp",
    params_spec=None,
    x_spec=P(),
):
    """Build `f(stacked_params, x_microbatched) -> y_microbatched`.

    stage_fn(stage_params, activation) -> activation, applied S times (S =
    the size of `axis`); stacked_params has a leading [S] stage axis; x is
    [M, mb, ...] microbatched input. The returned function runs under
    `shard_fn` over the mesh and is differentiable end to end."""
    S = axis_size(mesh, axis)
    M = num_microbatches

    def per_device(stacked_params, x):
        from ..collective.ops import psum

        params = pytree.tree_map(lambda p: p[0], stacked_params)  # local stage
        if x.shape[0] != M:
            raise ValueError(f"x has {x.shape[0]} microbatches, want {M}")
        outs, _ = gpipe_ticks(lambda a: (stage_fn(params, a), None), x, S, axis)
        # Only stage S-1 holds real outputs (the others hold zeros): the
        # psum replicates the result to every stage.
        return psum(outs, axis)

    if params_spec is None:
        params_spec = P(axis)
    return shard_fn(per_device, mesh, in_specs=(params_spec, x_spec), out_specs=x_spec)


def make_pipelined_loss_fn(
    stage_fn: Callable,
    loss_fn: Callable,
    mesh,
    *,
    num_microbatches: int,
    axis: str = "pp",
):
    """`f(stacked_params, batch_x, batch_target) -> scalar loss` with the
    pipeline inside; differentiable (the GPipe backward by autograd)."""
    gpipe = make_gpipe_fn(stage_fn, mesh, num_microbatches=num_microbatches, axis=axis)

    def fn(stacked_params, x, target):
        y = gpipe(stacked_params, split_microbatches(x, num_microbatches)).full_tensor()
        return loss_fn(merge_microbatches(y), target)

    return fn
