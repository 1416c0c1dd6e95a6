"""Device mesh construction: the counterpart of `ray_tpu/parallel/mesh.py`.

The reference expresses parallelism as a `jax.sharding.Mesh` with named
axes; the port builds a `torch.distributed.DeviceMesh` over the ranks of
the default process group, one mesh dim per axis of `AXIS_ORDER` whose
size is above 1 (a world of one rank: the one dim "dp" of size 1). An axis
the mesh lacks has size 1 wherever an axis is named: in specs, placements
and the collectives. DTensor enumerates its sharding strategies over every
mesh dim, so each size-1 dim would multiply the cost of every op it first
sees and change nothing. One rank drives one card (NCCL) or one CPU
process (gloo, `device_type="cpu"`). The canonical axes:

    dp    — data parallel (pure replica)
    fsdp  — fully-sharded data parallel (ZeRO-style weight sharding)
    tp    — tensor (model) parallel
    sp    — sequence/context parallel (ring attention rides this axis)
    ep    — expert parallel (MoE)
    pp    — pipeline stage

Shardings are DTensor placements: `ShardingRules.placements` maps logical
dims to one `Shard(tensor_dim)` or `Replicate()` per mesh dim, dropping
axes of size 1 as the reference's `sharding()` does. A tensor dim split
over two axes (`"batch": ("dp", "fsdp")`) is split major to minor in
`AXIS_ORDER`, which is DTensor's order for two `Shard`s of one dim.

`use_mesh` binds a mesh for the code under it (`spmd.shard_fn` binds its
own), so that `collective.ops.psum(x, "sp")` finds the axis's group.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


class PartitionSpec(tuple):
    """Per tensor dim: None (not split), a mesh axis name, or a tuple of
    names (split over their product, major to minor) — `jax.sharding.
    PartitionSpec`'s entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshSpec:
    """Named-axis mesh specification.

    >>> MeshSpec(dp=-1, tp=4).build("cuda")   # tp innermost
    """

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, num_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"At most one axis may be -1, got {unknown}")
        known = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if num_devices % known != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes product {known}"
                )
            sizes[unknown[0]] = num_devices // known
        elif known != num_devices:
            raise ValueError(
                f"Mesh {sizes} wants {known} devices but {num_devices} are available"
            )
        return MeshSpec(**sizes)

    def build(self, device_type: str = "cuda"):
        """The `DeviceMesh` over every rank of the default process group
        (one device per rank), dims named by the axes of size > 1 in
        `AXIS_ORDER`: `tp` (then `ep`, `sp`) innermost, so the heaviest
        collectives join neighbouring ranks. `device_type="cuda"` (the
        default) raises without a card; `"cpu"` builds a gloo mesh."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from ..device import resolve_device

        resolve_device(device_type)
        if not dist.is_initialized():
            raise RuntimeError(
                "no default process group: call torch.distributed.init_process_group "
                "(nccl for cuda, gloo for cpu) with this rank and the world size first")
        sizes = self.resolve(dist.get_world_size()).sizes()
        names = tuple(a for a in AXIS_ORDER if sizes[a] > 1) or ("dp",)
        return init_device_mesh(device_type, tuple(sizes[a] for a in names), mesh_dim_names=names)

    @property
    def num_devices(self) -> int:
        return math.prod(s for s in self.sizes().values() if s != -1)


def make_mesh(device_type: str = "cuda", **axis_sizes):
    """`make_mesh(dp=-1, tp=4)` -> DeviceMesh. Unmentioned axes are size 1."""
    return MeshSpec(**axis_sizes).build(device_type)


# ------------------------------------------------------- the bound mesh
_MESH: contextvars.ContextVar = contextvars.ContextVar("ray_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind `mesh` for the collectives called under this block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def bound_mesh():
    """The mesh bound by `use_mesh` / `shard_fn`, or None."""
    return _MESH.get()


def current_mesh():
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("no mesh is bound: call collectives under spmd.shard_fn or mesh.use_mesh")
    return mesh


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry or an axis argument as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, axis: str) -> int:
    """The size of mesh axis `axis`: 1 for an axis of `AXIS_ORDER` that the
    mesh lacks."""
    names = tuple(mesh.mesh_dim_names)
    if axis in names:
        return mesh.size(names.index(axis))
    if axis not in AXIS_ORDER:
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {AXIS_ORDER}")
    return 1


def spec_placements(mesh, spec: Sequence) -> List:
    """One placement per mesh dim for a tensor laid out by `spec`: Shard(i)
    on each axis that splits tensor dim i, Replicate elsewhere. Axes of size
    1 are dropped (Replicate), as the reference's `sharding()` drops them.
    Two axes of one entry split it major to minor, so they must come in
    `AXIS_ORDER`: DTensor splits a dim over mesh dims in mesh order. An axis
    of `AXIS_ORDER` that the mesh lacks has size 1."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * mesh.ndim
    used = set()
    for tdim, entry in enumerate(spec):
        axes = axes_of(entry)
        for a in axes:
            if a not in names and a not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {a!r} in {spec!r}")
        idx = [AXIS_ORDER.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec entry {entry!r} splits a dim minor-to-major; DTensor splits over mesh dims "
                f"in mesh order {tuple(names)}")
        for a in axes:
            if a in used:
                raise ValueError(f"mesh axis {a!r} appears twice in {spec!r}")
            used.add(a)
            if a in names and mesh.size(names.index(a)) > 1:
                placements[names.index(a)] = Shard(tdim)
    return placements


def place(x, mesh, placements):
    """`x` as a DTensor on `mesh` laid out by `placements` (one per mesh
    dim; differentiable). A plain tensor is taken as the global value, the
    same on every rank: each rank keeps its own shard of it, with no
    communication."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    elif x.device_mesh != mesh:
        raise ValueError(f"a DTensor on the mesh {x.device_mesh} cannot be placed on {mesh}")
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


# --------------------------------------------------------------- logical axes
@dataclass
class ShardingRules:
    """Logical-axis → mesh-axis rules (the t5x/maxtext idiom, re-derived).

    Model code annotates arrays with *logical* dim names; the rules decide
    which mesh axes they shard over. One place to retarget a model from pure
    DP to 3D DP×FSDP×TP without touching model code.
    """

    rules: Dict[str, Optional[Tuple[str, ...]]] = field(default_factory=dict)

    @classmethod
    def default(cls) -> "ShardingRules":
        return cls(
            rules={
                # Activations.
                "batch": ("dp", "fsdp"),
                "seq": ("sp",),
                "embed_act": None,           # activations replicated over tp...
                "heads_act": ("tp",),        # ...but heads split over tp
                "mlp_act": ("tp",),
                # Weights.
                "embed": ("fsdp",),          # ZeRO-shard the embed dim
                "heads": ("tp",),
                "kv_heads": ("tp",),
                "head_dim": None,
                "mlp": ("tp",),
                "vocab": ("tp",),
                "experts": ("ep",),
                "layers": None,              # stacked layer axis stays unsharded
                "stage": ("pp",),
            }
        )

    def spec(self, *logical_dims: Optional[str]) -> PartitionSpec:
        """Logical dims → `PartitionSpec`."""
        out = []
        for dim in logical_dims:
            if dim is None:
                out.append(None)
            else:
                if dim not in self.rules:
                    # A typo'd dim silently replicating would surface only as
                    # an OOM/perf mystery at scale — fail loudly.
                    raise KeyError(
                        f"Unknown logical dim {dim!r}; known: {sorted(self.rules)}. "
                        "Map it explicitly (None = replicated) via with_rules()."
                    )
                axes = self.rules[dim]
                if axes is None:
                    out.append(None)
                elif len(axes) == 1:
                    out.append(axes[0])
                else:
                    out.append(tuple(axes))
        return PartitionSpec(*out)

    def placements(self, mesh, *logical_dims: Optional[str]) -> List:
        """Logical dims → one DTensor placement per mesh dim (the reference's
        `sharding()`: axes of size 1 dropped)."""
        return spec_placements(mesh, self.spec(*logical_dims))

    def with_rules(self, **overrides) -> "ShardingRules":
        new = dict(self.rules)
        for k, v in overrides.items():
            new[k] = tuple(v) if isinstance(v, (list, tuple)) else ((v,) if v else None)
        return ShardingRules(rules=new)


def constrain(x, mesh, rules: ShardingRules, *logical_dims):
    """`lax.with_sharding_constraint` via logical dims: `x` redistributed to
    the rules' placements. Errors (rank mismatch, unknown dims) propagate."""
    if len(logical_dims) != x.dim():
        raise ValueError(f"{len(logical_dims)} logical dims for a {x.dim()}-dim tensor")
    return place(x, mesh, rules.placements(mesh, *logical_dims))
