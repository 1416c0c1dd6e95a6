"""SPMD execution over a `DeviceMesh`: the counterpart of
`ray_tpu/parallel/spmd.py`.

The reference has two modes, and so has the port:

* `parallelize` (pjit): the inputs are placed by their shardings and the
  function runs on DTensors, whose sharding propagation plays XLA's part.
* `shard_fn` (shard_map): the function runs on each rank's LOCAL shards;
  the collectives inside it (`collective.ops`) are named by mesh axis.

A sharding here is a `PartitionSpec` (resolved against the mesh by
`mesh.spec_placements`) or a list of DTensor placements, one per mesh dim.
Either applies to every tensor of the argument it stands for (a dict of
params takes one spec), or a dict/list/tuple of them mirrors the argument.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from .mesh import AXIS_ORDER, PartitionSpec, axes_of, axis_size, place, spec_placements, use_mesh


def _is_sharding(s) -> bool:
    from torch.distributed.tensor.placement_types import Placement

    return isinstance(s, PartitionSpec) or (
        isinstance(s, (list, tuple)) and len(s) > 0 and all(isinstance(p, Placement) for p in s))


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _map_specs(specs, tree, fn):
    """fn(tensor, sharding) over `tree`, with `specs` a sharding or a
    prefix of the tree's structure."""
    if specs is None:
        return tree
    if _is_sharding(specs):
        return _map_tensors(tree, lambda t: fn(t, specs))
    if isinstance(specs, dict):
        return {k: _map_specs(specs[k], v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and len(specs) == len(tree):
        return type(tree)(_map_specs(s, v, fn) for s, v in zip(specs, tree))
    raise ValueError(f"shardings {specs!r} do not match the structure of the arguments")


def _placements(mesh, s):
    return spec_placements(mesh, s) if isinstance(s, PartitionSpec) else list(s)


def parallelize(fn: Callable, mesh, in_shardings=None, out_shardings=None) -> Callable:
    """`fn` over `mesh` with explicit shardings (the pjit idiom): each input
    becomes a DTensor placed by its sharding (a plain tensor is the global
    value, the same on every rank), `fn` runs on DTensors with `mesh`
    bound, and each output is redistributed to its sharding. None leaves
    the inputs as given, or the outputs as DTensor propagation made them."""

    def put(x, s):
        return place(x, mesh, _placements(mesh, s))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args = _map_specs(in_shardings, args, put)
        with use_mesh(mesh):
            out = fn(*args, **kwargs)
        return _map_specs(out_shardings, out, put)

    return wrapper


# -------------------------------------------------------------- shard_map
class _SumGradOver(torch.autograd.Function):
    """Identity forward; the cotangent summed over `axes` (a psum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from ..collective.ops import psum

        with use_mesh(ctx.mesh):
            return psum(g, ctx.axes), None, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times `scale`."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _unmentioned(mesh, spec, manual) -> tuple:
    """The manual axes of size > 1 that `spec` does not split over."""
    named = {a for entry in spec for a in axes_of(entry)}
    return tuple(a for a in manual if a not in named and axis_size(mesh, a) > 1)


def shard_fn(
    fn: Callable,
    mesh,
    in_specs,
    out_specs,
    check_vma: bool = False,
    manual_axes: Optional[frozenset] = None,
) -> Callable:
    """`shard_map`: `fn` runs on each rank's local shards, with `mesh` bound
    for the collectives it calls (ring attention, Ulysses all-to-all and
    expert-parallel MoE live here).

    Each input (a DTensor, or a plain tensor taken as the global value) is
    redistributed to its spec and handed over as the local shard; each
    output is taken as the local shard of a DTensor laid out by its spec.
    An output replicated over an axis must be the same on every rank of it.

    Gradients follow the reference's `shard_map(check_vma=False)` (which is
    how it calls this), so they equal the reference's: an output's
    cotangent is divided by the size of the axes its spec does not split
    over, an input's cotangent is summed over the axes its spec does not
    split over, and `psum`'s own transpose is a psum.

    `manual_axes` makes only those axes manual: the local values stay
    DTensors over the sub-mesh of the other axes, which DTensor keeps
    partitioning (specs may name manual axes only).
    """
    if check_vma:
        raise NotImplementedError("shard_fn runs with replication checks off (check_vma=False), "
                                  "as the reference calls it")
    names = tuple(mesh.mesh_dim_names)
    manual = tuple(a for a in names if manual_axes is None or a in manual_axes)
    auto = tuple(a for a in names if a not in manual)
    sub = mesh[auto] if auto else None  # where the body's DTensors live
    absent = set(AXIS_ORDER) - set(names)  # size 1: a spec may name them

    def check(spec):
        bad = {a for entry in spec for a in axes_of(entry)} - set(manual) - absent
        if bad:
            raise ValueError(f"spec {spec!r} names axes that are not manual: {sorted(bad)}")

    def to_local(x, spec):
        from torch.distributed.tensor import DTensor

        check(spec)
        want = spec_placements(mesh, spec)
        if auto and isinstance(x, DTensor):  # keep the input's own layout over the automatic axes
            want = [want[i] if a in manual else x.placements[i] for i, a in enumerate(names)]
        local = place(x, mesh, want).to_local()
        local = _SumGradOver.apply(local, mesh, _unmentioned(mesh, spec, manual))
        if auto:
            local = DTensor.from_local(local, sub, [want[names.index(a)] for a in auto], run_check=False)
        return local

    def from_local(y, spec):
        from torch.distributed.tensor import DTensor

        check(spec)
        placements = spec_placements(mesh, spec)
        if auto and isinstance(y, DTensor):
            for a, p in zip(y.device_mesh.mesh_dim_names, y.placements):
                placements[names.index(a)] = p
            y = y.to_local()
        scale = math.prod(axis_size(mesh, a) for a in _unmentioned(mesh, spec, manual))
        if scale > 1:
            y = _ScaleGrad.apply(y, 1.0 / scale)
        return DTensor.from_local(y, mesh, placements, run_check=False)

    @functools.wraps(fn)
    def wrapper(*args):
        local_args = _map_specs(in_specs, args, to_local)
        with use_mesh(mesh):
            out = fn(*local_args)
        return _map_specs(out_specs, out, from_local)

    return wrapper
