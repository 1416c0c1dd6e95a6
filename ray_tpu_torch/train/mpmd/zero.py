"""ZeRO-style sharded weight update over a stage's data-parallel replicas
(port of `ray_tpu/train/mpmd/zero.py`).

The ZeRO idea (arXiv 2004.13336): gradients REDUCE-SCATTER across the dp
group, each replica updates only its 1/dp chunk of the flat f32 optimizer
state (adam m/v + f32 master params), and the updated parameter chunks
ALL-GATHER back into the full working tree — optimizer memory per replica
drops ~dp x vs a replicated adamw.

Layout contract: the flat space is chunked with np.array_split sizing
(`collective.ops.zero_shard_bounds`) — the SAME rule the host-plane
`collective.reduce_scatter_flat` uses for wire chunks and the elastic
checkpoint's axis-0 reshard applies on restore, so optimizer shards saved
at dp=4 restore as exactly the runtime chunks at dp=2.

Bit-parity contract: `ReplicatedAdamW` (the A/B baseline) reduces gradients
through the SAME reduce-scatter + all-gather pair before its full-width
update. AdamW is elementwise, so update-shard-then-gather and
gather-then-update produce bit-identical parameters. Memory is the only
difference between the two paths.

The port keeps the flat master, m and v as f32 tensors on the device of
the flat vector it was built from (the runner's), and runs the reference's
jitted update (`_adamw_jit`) as the same elementwise f32 operations, one
torch op each, in the reference's order; scalars are 0-d f32 tensors on
that device, so every operation rounds once in f32 whatever the device.

Comm backends (tensors in, tensors out): `StoreDpComm` rides the host-plane
object-store collectives (separate replica processes; its chunks cross as
host numpy arrays, the plane's currency); `LocalDpComm` is an in-process
thread group for the parity tests and the local pipeline runner;
`SoloComm` is the dp=1 degenerate.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from ...collective.ops import zero_shard_bounds


def _flat(x) -> torch.Tensor:
    """A flat f32 tensor of x (a tensor, on its device, or an array)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x, dtype=np.float32, copy=True))
    return torch.as_tensor(x).to(torch.float32).reshape(-1)


def _from_host(arr: np.ndarray, device) -> torch.Tensor:
    """A host-plane result back on `device` (a read-only array is copied:
    torch does not take one)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


class SoloComm:
    """dp = 1: collectives are identity."""

    world = 1
    rank = 0

    def reduce_scatter_flat(self, vec: torch.Tensor) -> torch.Tensor:
        return vec.reshape(-1).clone()

    def all_gather_flat(self, chunk: torch.Tensor) -> torch.Tensor:
        return chunk.reshape(-1).clone()


class StoreDpComm:
    """Host-plane dp group between replica PROCESSES: wraps
    `ray_tpu_torch.collective.{reduce_scatter_flat,all_gather_flat}` for one
    named group. The caller must have joined the group
    (init_collective_group) on the thread that runs the collectives. A
    tensor crosses as a host numpy array and comes back on its device."""

    def __init__(self, group_name: str, world: int, rank: int):
        self.group_name = group_name
        self.world = world
        self.rank = rank

    def reduce_scatter_flat(self, vec: torch.Tensor) -> torch.Tensor:
        from ... import collective

        out = collective.reduce_scatter_flat(vec.detach().reshape(-1).cpu().numpy(), group_name=self.group_name)
        return _from_host(out, vec.device)

    def all_gather_flat(self, chunk: torch.Tensor) -> torch.Tensor:
        from ... import collective

        out = collective.all_gather_flat(chunk.detach().reshape(-1).cpu().numpy(), group_name=self.group_name)
        return _from_host(out, chunk.device)


class _LocalGroupState:
    """Shared rendezvous for an in-process dp group (threads)."""

    def __init__(self, world: int):
        self.world = world
        self.cond = threading.Condition()
        self.rounds: Dict[str, dict] = {}

    def exchange(self, key: str, rank: int, value, timeout: float = 60.0) -> List:
        """Deposit `value` for round `key`; block until every rank has;
        return values in rank order. The last rank to leave frees the
        round."""
        with self.cond:
            r = self.rounds.setdefault(key, {"vals": {}, "served": 0})
            r["vals"][rank] = value
            self.cond.notify_all()
            if not self.cond.wait_for(lambda: len(r["vals"]) >= self.world, timeout):
                raise TimeoutError(f"local dp round {key} timed out")
            out = [r["vals"][k] for k in sorted(r["vals"])]
            r["served"] += 1
            if r["served"] >= self.world:
                self.rounds.pop(key, None)
            return out


class LocalDpComm:
    """In-process dp group member (one per replica thread)."""

    def __init__(self, state: _LocalGroupState, rank: int):
        self._state = state
        self.world = state.world
        self.rank = rank
        self._seq = 0

    def _next(self, tag: str) -> str:
        self._seq += 1
        return f"{tag}:{self._seq}"

    def reduce_scatter_flat(self, vec: torch.Tensor) -> torch.Tensor:
        vals = self._state.exchange(self._next("rs"), self.rank, vec.reshape(-1))
        # Sorted-rank reduction order, matching the host plane's _reduce —
        # every rank computes bit-identical chunks.
        lo, hi = zero_shard_bounds(vals[0].shape[0], self.world, self.rank)
        out = vals[0][lo:hi].clone()
        for v in vals[1:]:
            out = out + v[lo:hi]
        return out

    def all_gather_flat(self, chunk: torch.Tensor) -> torch.Tensor:
        vals = self._state.exchange(self._next("ag"), self.rank, chunk.reshape(-1))
        return torch.cat(vals)


def make_local_comms(world: int) -> List[LocalDpComm]:
    state = _LocalGroupState(world)
    return [LocalDpComm(state, r) for r in range(world)]


# ----------------------------------------------------------------- optimizer
def _adamw(master, m, v, g, t, lr, b1, b2, eps, wd):
    """The reference's `_adamw_jit` update (`ray_tpu/train/mpmd/zero.py:141-154`)
    in f32 torch, each operation of it once, in its order; `m`, `v` and
    `master` are updated in place (the values are the functional ones)."""
    m.mul_(b1).add_((1.0 - b1) * g)           # b1 * m + (1 - b1) * g
    v.mul_(b2).add_((1.0 - b2) * g * g)       # b2 * v + (1 - b2) * g * g
    mhat = m / (1.0 - b1 ** t)
    vhat = v / (1.0 - b2 ** t)
    step = mhat.div_(vhat.sqrt_().add_(eps))  # mhat / (sqrt(vhat) + eps)
    step.add_(wd * master).mul_(lr)           # lr * (... + wd * master)
    master.sub_(step)
    return master, m, v


def _sumsq(g: torch.Tensor) -> float:
    """sum(g**2) in f64 (the reference's `np.square(g, dtype=np.float64)`),
    a slice at a time so no f64 copy of a large gradient is made."""
    total = torch.zeros((), dtype=torch.float64, device=g.device)
    for part in g.split(1 << 24):
        total += part.double().square().sum()
    return float(total)


class _AdamWBase:
    def __init__(self, init_flat, comm, lr: float = 1e-3, betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.comm = comm
        self.n = int(_flat(init_flat).shape[0])
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.t = 0

    def _update(self, master, m, v, g):
        self.t += 1

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=master.device)

        return _adamw(master, m, v, g, f32(self.t), f32(self.lr), f32(self.betas[0]), f32(self.betas[1]),
                      f32(self.eps), f32(self.wd))

    def _reduced(self, local_grad_flat) -> torch.Tensor:
        """This rank's chunk of the dp-MEAN gradient (reduce-scatter sum,
        then / world) — the one reduction both paths share."""
        chunk = self.comm.reduce_scatter_flat(_flat(local_grad_flat))
        if self.comm.world > 1:
            chunk = chunk / torch.tensor(self.comm.world, dtype=torch.float32, device=chunk.device)
        return chunk

    def _state_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in (self.master, self.m, self.v))

    def _state_tree(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name).detach().cpu() for name in ("master", "m", "v")}


class ShardedAdamW(_AdamWBase):
    """ZeRO path: optimizer state holds ONLY this rank's chunk."""

    def __init__(self, init_flat, comm, **kw):
        super().__init__(init_flat, comm, **kw)
        lo, hi = zero_shard_bounds(self.n, comm.world, comm.rank)
        self.bounds = (lo, hi)
        flat = _flat(init_flat)
        self.master = flat[lo:hi].clone()
        self.m = torch.zeros_like(self.master)
        self.v = torch.zeros_like(self.master)

    @property
    def optimizer_bytes(self) -> int:
        return self._state_bytes()

    def step(self, local_grad_flat):
        """Returns (full updated flat params [n] f32, grad_sumsq of the
        dp-mean gradient — summed across chunks via a scalar gather so
        every rank reports the global value)."""
        g = self._reduced(local_grad_flat)
        self._update(self.master, self.m, self.v, g)
        full = self.comm.all_gather_flat(self.master)
        chunk_sq = _sumsq(g)
        if self.comm.world > 1:
            parts = self.comm.all_gather_flat(torch.tensor([chunk_sq], dtype=torch.float32, device=g.device))
            return full, float(parts.sum())
        return full, chunk_sq

    # --------------------------------------------------------- checkpoint
    def ckpt_tree(self) -> Dict[str, torch.Tensor]:
        """Axis-0-shardable state as CPU tensors (the port's
        `ShardedCheckpoint` keeps torch tensors): each leaf is this rank's
        chunk, and the concatenation across ranks is the full flat space —
        exactly the shape `ShardedCheckpoint.restore`'s reshard rule
        redistributes on a dp change."""
        return self._state_tree()

    def load_ckpt_tree(self, tree: Dict[str, torch.Tensor], t: int) -> None:
        lo, hi = self.bounds
        for name in ("master", "m", "v"):
            got = _flat(tree[name])
            if got.shape[0] != hi - lo:
                raise ValueError(
                    f"restored {name} chunk has {got.shape[0]} elements, "
                    f"rank {self.comm.rank}/{self.comm.world} owns {hi - lo}"
                )
            setattr(self, name, got.to(self.master.device, copy=True))
        self.t = int(t)

    def full_flat(self) -> torch.Tensor:
        return self.comm.all_gather_flat(self.master)


class ReplicatedAdamW(_AdamWBase):
    """A/B baseline: every replica holds the FULL optimizer state. The
    gradient reduction is the same reduce-scatter + all-gather pair as the
    ZeRO path, so the two produce bit-identical parameters; per-replica
    optimizer memory (dp x larger) is the measured difference."""

    def __init__(self, init_flat, comm, **kw):
        super().__init__(init_flat, comm, **kw)
        self.master = _flat(init_flat).clone()
        self.m = torch.zeros_like(self.master)
        self.v = torch.zeros_like(self.master)

    @property
    def optimizer_bytes(self) -> int:
        return self._state_bytes()

    def step(self, local_grad_flat):
        chunk = self._reduced(local_grad_flat)
        g = self.comm.all_gather_flat(chunk) if self.comm.world > 1 else chunk
        self._update(self.master, self.m, self.v, g)
        return self.master.clone(), _sumsq(g)

    def ckpt_tree(self) -> Dict[str, torch.Tensor]:
        return self._state_tree()

    def load_ckpt_tree(self, tree: Dict[str, torch.Tensor], t: int) -> None:
        for name in ("master", "m", "v"):
            got = _flat(tree[name])
            if got.shape[0] != self.n:
                raise ValueError(
                    f"restored {name} has {got.shape[0]} elements, "
                    f"model flat space has {self.n}"
                )
            setattr(self, name, got.to(self.master.device, copy=True))
        self.t = int(t)

    def full_flat(self) -> torch.Tensor:
        return self.master.clone()
