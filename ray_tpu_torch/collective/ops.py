"""In-program collectives over a `DeviceMesh`: the counterpart of
`ray_tpu/collective/ops.py`.

The reference calls `jax.lax.p*` inside `shard_map`; here each function
runs per rank, under `parallel.spmd.shard_fn` (or `mesh.use_mesh`), on the
local tensor, through `torch.distributed` over the process group of the
named mesh axis. A tuple of axes, such as `("dp", "fsdp")`, names the group
of the flattened sub-mesh, ranks ordered major to minor as the reference
linearizes them. Each differentiable collective is an autograd Function
whose backward is the reference's transpose under `shard_map(check_vma=
False)`: psum → psum, all_gather → reduce_scatter (tiled sum),
reduce_scatter → all_gather, all_to_all → all_to_all with the split and
concat axes swapped, ppermute → ppermute along the inverted permutation.
pmax/pmin have no gradient, as in the reference.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from ..parallel.mesh import axes_of, current_mesh, use_mesh
from ..parallel.mesh import axis_size as mesh_axis_size

AxisName = Union[str, Sequence[str]]

_GROUPS: dict = {}


def _present(axis: AxisName):
    """(bound mesh, the axes of `axis` that it has): an axis of
    `AXIS_ORDER` that the mesh lacks has size 1 and joins no group."""
    mesh = current_mesh()
    axes = axes_of(axis)
    for a in axes:
        mesh_axis_size(mesh, a)  # an unknown name raises
    return mesh, tuple(a for a in axes if a in mesh.mesh_dim_names)


def _group(axis: AxisName):
    """The process group of `axis` on the bound mesh (a tuple of axes: the
    flattened sub-mesh's group, made once per mesh by every rank)."""
    mesh, axes = _present(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
        raise NotImplementedError(f"axes {axes} must come in mesh order {tuple(names)}")
    key = (id(mesh), axes)
    if key not in _GROUPS:
        _GROUPS[key] = (mesh, mesh[axes]._flatten("_".join(axes)).get_group())
    return _GROUPS[key][1]


def axis_size(axis: AxisName) -> int:
    mesh = current_mesh()
    return math.prod(mesh_axis_size(mesh, a) for a in axes_of(axis))


def axis_index(axis: AxisName) -> int:
    """This rank's index along `axis` (a tuple: linearized major to minor)."""
    mesh, axes = _present(axis)
    idx = 0
    for a in axes:
        idx = idx * mesh_axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def _peer(axis: AxisName, index: int) -> int:
    """The global rank at `index` along `axis`, this rank's coordinates on
    every other axis."""
    mesh, axes = _present(axis)
    names = list(mesh.mesh_dim_names)
    coord = list(mesh.get_coordinate())
    for a in reversed(axes):
        n = mesh_axis_size(mesh, a)
        coord[names.index(a)] = index % n
        index //= n
    return int(mesh.mesh[tuple(coord)])


def _all_reduce(x, op, axis):
    import torch.distributed as dist

    out = x.contiguous().clone()
    if axis_size(axis) > 1:
        dist.all_reduce(out, op=op, group=_group(axis))
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        import torch.distributed as dist

        ctx.axis, ctx.mesh = axis, current_mesh()
        return _all_reduce(x, dist.ReduceOp.SUM, axis)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return psum(g, ctx.axis), None


def psum(x, axis: AxisName):
    """Sum over the ranks of `axis`. A Python number is multiplied by the
    axis size, as the reference's psum of a constant is."""
    if not isinstance(x, torch.Tensor):
        return x * axis_size(axis)
    if axis_size(axis) == 1:
        return x
    return _Psum.apply(x, axis)


def pmean(x, axis: AxisName):
    return psum(x, axis) / axis_size(axis)


class _NoGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, op, name):
        ctx.name = name
        return _all_reduce(x, op, axis)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(f"Differentiation rule for '{ctx.name}' not implemented")


def pmax(x, axis: AxisName):
    import torch.distributed as dist

    return _NoGrad.apply(x, axis, dist.ReduceOp.MAX, "pmax")


def pmin(x, axis: AxisName):
    import torch.distributed as dist

    return _NoGrad.apply(x, axis, dist.ReduceOp.MIN, "pmin")


def allreduce_jit(x, axis: AxisName, op: str = "sum"):
    return {"sum": psum, "mean": pmean, "max": pmax, "min": pmin}[op](x, axis)


def _gather0(x, axis):
    """Tiled all-gather along dim 0."""
    import torch.distributed as dist

    x = x.contiguous()
    out = x.new_empty((axis_size(axis) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=_group(axis))
    return out


def _scatter0(x, axis):
    """Tiled reduce-scatter (sum) along dim 0."""
    import torch.distributed as dist

    n = axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim of size {x.shape[0]} does not split over {n} ranks")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=_group(axis))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, current_mesh()
        return _gather0(x.movedim(dim, 0), axis).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _ReduceScatter.apply(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, current_mesh()
        return _scatter0(x.movedim(dim, 0), axis).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _AllGather.apply(g, ctx.axis, ctx.dim), None, None


def all_gather(x, axis: AxisName, *, tiled: bool = True, gather_axis: int = 0):
    """The ranks' x concatenated along `gather_axis` in rank order (tiled),
    or stacked on a new axis there (not tiled)."""
    gather_axis %= x.dim() + (0 if tiled else 1)
    if not tiled:
        x = x.unsqueeze(gather_axis)
    return x if axis_size(axis) == 1 else _AllGather.apply(x, axis, gather_axis)


def reduce_scatter(x, axis: AxisName, *, scatter_axis: int = 0, op: str = "sum"):
    if op not in ("sum", "mean"):
        raise NotImplementedError("reduce_scatter supports sum/mean")
    if axis_size(axis) == 1:
        return x
    out = _ReduceScatter.apply(x, axis, scatter_axis % x.dim())
    if op == "mean":
        out = out / axis_size(axis)
    return out


def _all_to_all(x, axis, split_axis: int, concat_axis: int):
    """Tiled all-to-all: split x into n chunks along split_axis, chunk j to
    rank j; the chunks received, in rank order, concatenated along
    concat_axis."""
    import torch.distributed as dist

    n = axis_size(axis)
    if n == 1:
        return x.clone()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim of size {x.shape[split_axis]} does not split over {n} ranks")
    xs = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=_group(axis))
    # out[j] holds rank j's chunk for this rank: [n, c, ...] -> chunk dims back in place
    pieces = out.view(n, xs.shape[0] // n, *xs.shape[1:]).movedim(1, split_axis + 1)
    shape = list(pieces.shape[1:])
    shape[concat_axis] *= n
    return pieces.movedim(0, concat_axis).reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args, ctx.mesh = (axis, concat_axis, split_axis), current_mesh()
        return _all_to_all(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _AllToAll.apply(g, *ctx.args), None, None, None


def all_to_all(x, axis: AxisName, *, split_axis: int, concat_axis: int, tiled: bool = True):
    """Ulysses-style head/sequence exchange rides this. Not tiled, the split
    dim (of size n) is removed and a dim of size n inserted at concat_axis,
    as `jax.lax.all_to_all`."""
    if tiled:
        if axis_size(axis) == 1:
            return x
        return _AllToAll.apply(x, axis, split_axis % x.dim(), concat_axis % x.dim())
    split_axis %= x.dim()
    concat_axis %= x.dim()
    # A size-1 dim that lands at concat_axis once the split dim is squeezed.
    new = concat_axis if concat_axis <= split_axis else concat_axis + 1
    split = split_axis + 1 if concat_axis <= split_axis else split_axis
    return _AllToAll.apply(x.unsqueeze(new), axis, split, new).squeeze(split)


def _ppermute(x, axis, perm):
    import torch.distributed as dist

    me = axis_index(axis)
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), _peer(axis, dst), _group(axis)))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _peer(axis, src), _group(axis)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, current_mesh()
        return _ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _Ppermute.apply(g, ctx.axis, tuple((d, s) for s, d in ctx.perm)), None, None


def ppermute(x, axis: AxisName, perm: Sequence[tuple]):
    """Neighbor exchange — the ring-attention building block: rank src's x
    goes to rank dst for each (src, dst); a rank nobody sends to gets 0."""
    return _Ppermute.apply(x, axis, tuple((int(s), int(d)) for s, d in perm))


def ring_shift(x, axis: str, shift: int = 1):
    """Send x to (rank+shift) mod n along `axis`; returns the received block."""
    n = axis_size(axis)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])


def barrier_jit(axis: AxisName):
    """Sync point: a zero-sized psum forces a collective."""
    return psum(torch.zeros((), dtype=torch.int32, device=_device()), axis)


def _device():
    mesh = current_mesh()
    return torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" \
        else torch.device(mesh.device_type)


def unreplicate(tree):
    """Take the first element along a leading device axis (host-side)."""
    if isinstance(tree, dict):
        return {k: unreplicate(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unreplicate(v) for v in tree)
    return tree[0]


# ------------------------------------------------------- ZeRO flat sharding
# Helpers for the cross-replica sharded weight update (arXiv 2004.13336):
# the optimizer works in ONE flat f32 parameter space, each data-parallel
# replica owning a contiguous chunk of it. Chunk boundaries use
# np.array_split sizing, the partitioning rule of the reference's elastic
# checkpoint reshard, so a chunk saved at one world size restores at
# another with no re-padding. Any flat length works for any world size.


def zero_shard_bounds(n: int, world: int, rank: int) -> "tuple[int, int]":
    """[start, end) of rank's chunk of a flat length-n vector under
    np.array_split sizing (first n % world chunks get one extra element)."""
    q, rem = divmod(int(n), int(world))
    start = rank * q + min(rank, rem)
    return start, start + q + (1 if rank < rem else 0)


def _leaves(tree, prefix=()):
    """(key path, tensor) of a (nested) dict of tensors, keys sorted at each
    level: the order `jax.tree_util` flattens a dict in."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def zero_flatten(state):
    """A (nested) dict of tensors -> (flat f32 1-D tensor, spec). Leaves in
    sorted key order, so the flat vector equals the reference's for the same
    arrays; `spec` (key paths, shapes and dtypes) round-trips through
    zero_unflatten. Master/optimizer math runs in f32 whatever the working
    dtype."""
    leaves = [(path, torch.as_tensor(x)) for path, x in _leaves(state)]
    spec = {"paths": [p for p, _ in leaves], "leaves": [(tuple(x.shape), x.dtype) for _, x in leaves]}
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32), spec
    flat = torch.cat([x.detach().reshape(-1).to(torch.float32) for _, x in leaves])
    return flat, spec


def zero_unflatten(flat, spec, cast: bool = True):
    """Inverse of zero_flatten: the nested dict, each leaf cast back to its
    recorded dtype (cast=False keeps f32)."""
    out, pos = {}, 0
    for path, (shape, dtype) in zip(spec["paths"], spec["leaves"]):
        n = math.prod(shape)
        leaf = flat[pos:pos + n].reshape(shape)
        if cast:
            leaf = leaf.to(dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path:
            node[path[-1]] = leaf
        else:
            return leaf
        pos += n
    return out
