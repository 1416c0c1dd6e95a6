"""StageRunner — one pipeline-stage replica's training loop body (port of
`ray_tpu/train/mpmd/stage.py`).

Process-agnostic: the cluster trainer hosts one of these per gang actor
(edges = compiled-DAG channels, comm = host-plane collectives), the local
runner hosts them on threads (queue edges, in-process comm). Each runner
owns ONE stage's programs — MPMD: S stages run S different programs,
nothing here runs over a pp axis. With interleaving (num_chunks = v > 1)
the runner owns v chunk programs (virtual stage vs = c*S + s per chunk c)
and per-chunk edges; all v chunk param trees live in ONE flat ZeRO space
so the sharded update is a single reduce-scatter/all-gather per step.

Per step (`run_step`): execute the (interleaved) 1F1B op list; accumulate
this replica's per-chunk gradients on the device; reconcile the tied
embedding's gradient over the first/last-stage bridge if bound; then the
ZeRO update — reduce-scatter the flat gradient across the stage's dp
group, update this replica's optimizer-state chunk, all-gather the
updated parameters (zero=False swaps in the replicated-state baseline
with the identical gradient reduction).

The port's programs are eager torch (`gpt.make_mpmd_stage_fns`); the
working params are f32 tensors on the runner's device (`device=`, the
card unless the caller asks for the CPU), views of the flat space the
optimizer returns after each update. Each step's metrics carry the kernel
launches it made (`launches`: the counts of the four kernel wrappers, read
before and after the step).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ...collective.ops import zero_flatten, zero_unflatten
from ...device import resolve_device
from ..elastic.state import ElasticState
from .schedule import B, F, build_interleaved_1f1b
from .zero import ReplicatedAdamW, ShardedAdamW, SoloComm


@functools.lru_cache(maxsize=64)
def _jit_stage_fns(cfg, stage: int, num_stages: int, num_chunks: int = 1, chunk: int = 0) -> Dict[str, Any]:
    """Process-cached chunk programs (the reference jits them here; the
    port's are eager, so the cache only saves rebuilding the closures):
    GPTConfig is a frozen (hashable) dataclass."""
    from ...models import gpt

    return gpt.make_mpmd_stage_fns(cfg, stage, num_stages, num_chunks=num_chunks, chunk=chunk)


def _acc_jit():
    """The gradient accumulation (the reference jits a tree add): an
    in-place add of the new microbatch's gradients onto the running sum."""

    def acc(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
        for k, g in b.items():
            a[k].add_(g)
        return a

    return acc


def _as_chunk_list(x, num_chunks: int) -> List[Any]:
    """Normalize an edge argument: None -> all-None, a single edge ->
    chunk 0 (the v=1 call shape), a list -> itself (must be length v)."""
    if x is None:
        return [None] * num_chunks
    if isinstance(x, (list, tuple)):
        if len(x) != num_chunks:
            raise ValueError(f"expected {num_chunks} edges, got {len(x)}")
        return list(x)
    if num_chunks != 1:
        raise ValueError("interleaved runners need per-chunk edge lists")
    return [x]


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the four kernel wrappers in this process (a
    step's difference is its own where one runner has the process, as a
    stage actor does; threads of the local pipeline share the counts)."""
    from ...kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from ...kernels.flash_fwd import flash_fwd
    from ...kernels.rmsnorm import rmsnorm_fwd

    return {"flash_fwd": flash_fwd.launches, "flash_bwd_dq": flash_bwd_dq.launches,
            "flash_bwd_dkv": flash_bwd_dkv.launches, "rmsnorm": rmsnorm_fwd.launches}


class StageRunner:
    def __init__(
        self,
        cfg,
        stage: int,
        num_stages: int,
        num_microbatches: int,
        stage_params,
        comm=None,
        *,
        replica: int = 0,
        num_chunks: int = 1,
        zero: bool = True,
        lr: float = 1e-3,
        betas=(0.9, 0.95),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        device=None,
    ):
        # The runner's device (the port's): the card unless asked for the CPU.
        self.device = resolve_device(device)
        self.cfg = cfg
        self.stage = stage
        # dp-replica index — only used to label this runner's flight lanes
        # and metric series; the comm object carries the collective rank.
        self.replica = replica
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.num_chunks = num_chunks
        # first/last mean "hosts the first/last VIRTUAL stage": chunk 0 of
        # stage 0 embeds tokens, chunk v-1 of stage S-1 computes the loss.
        self.first = stage == 0
        self.last = stage == num_stages - 1
        self.comm = comm or SoloComm()
        self.zero = zero
        # Validates (S, M, v) — incl. M % S == 0 for v > 1 — up front.
        self._ops = build_interleaved_1f1b(stage, num_stages, num_microbatches, num_chunks)

        self._fns = [_jit_stage_fns(cfg, stage, num_stages, num_chunks, c) for c in range(num_chunks)]
        self._acc = _acc_jit()

        chunk_trees = list(stage_params) if isinstance(stage_params, (list, tuple)) else [stage_params]
        if len(chunk_trees) != num_chunks:
            raise ValueError(
                f"stage {stage} got {len(chunk_trees)} chunk param trees, "
                f"expected {num_chunks}"
            )
        # ONE flat f32 space covering all chunks: v=1 keeps the bare tree
        # (flat layout — and so checkpoints — bit-identical to the
        # pre-interleaving layout); v>1 namespaces chunks as {"c0": .., ..}.
        tree = chunk_trees[0] if num_chunks == 1 else {f"c{c}": t for c, t in enumerate(chunk_trees)}
        tree = _tree_map(lambda x: torch.as_tensor(x).to(self.device), tree)
        flat, self._spec = zero_flatten(tree)
        del tree
        opt_cls = ShardedAdamW if zero else ReplicatedAdamW
        self.opt = opt_cls(flat, self.comm, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        self.params = zero_unflatten(flat, self._spec)
        self.state = ElasticState()
        # Per-chunk edges (bind_edges): None where the virtual-stage chain
        # boundary is. The bridge pair reconciles the tied embedding grad.
        self.fwd_in = [None] * num_chunks
        self.fwd_out = [None] * num_chunks
        self.bwd_in = [None] * num_chunks
        self.bwd_out = [None] * num_chunks
        self.bridge_out = self.bridge_in = None
        self.last_busy_s = 0.0
        self.last_update_s = 0.0

    # ---------------------------------------------------------------- wiring
    def bind_edges(self, fwd_in=None, fwd_out=None, bwd_in=None, bwd_out=None, bridge_out=None, bridge_in=None):
        v = self.num_chunks
        self.fwd_in = _as_chunk_list(fwd_in, v)
        self.fwd_out = _as_chunk_list(fwd_out, v)
        self.bwd_in = _as_chunk_list(bwd_in, v)
        self.bwd_out = _as_chunk_list(bwd_out, v)
        self.bridge_out, self.bridge_in = bridge_out, bridge_in

    def _chunk_params(self, c: int):
        return self.params if self.num_chunks == 1 else self.params[f"c{c}"]

    def _sync(self) -> None:
        """Wait for the device (the reference's `block_until_ready`)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ step
    def run_step(self, tokens) -> Dict[str, Any]:
        """One training step over this replica's batch slice. `tokens`
        [b, S+1] (an int array or tensor) feeds the first stage's inputs
        and the last stage's targets (both when S == 1); interior stages
        take None."""
        M, v, S = self.num_microbatches, self.num_chunks, self.num_stages
        P = S * v
        launches0 = kernel_launches()
        inputs = targets = None
        if self.first or self.last:
            if tokens is None:
                raise ValueError(f"stage {self.stage} is a pipeline boundary and needs the batch slice")
            tokens = torch.as_tensor(tokens).to(self.device)
            b = tokens.shape[0]
            if b % M != 0:
                raise ValueError(f"replica batch {b} not divisible by {M} microbatches")
            mb = b // M
            if self.first:
                inputs = tokens[:, :-1].reshape(M, mb, -1)
            if self.last:
                targets = tokens[:, 1:].reshape(M, mb, -1)

        from ...util import flight

        # Flight-recorder slot spans: a lane per (stage, chunk, dp-replica)
        # and a flow key per (step, microbatch, chunk, replica), so the
        # merged view draws the 1F1B wave with arrows following each
        # microbatch across stages. Timing uses monotonic_ns for BOTH the
        # busy accounting and the spans (one clock, one read per boundary).
        fl = flight.recorder() if flight.enabled() else None
        if fl is not None:
            flight.ensure_flusher()
        lanes = [f"mpmd/s{self.stage}c{c}r{self.replica}" for c in range(v)]
        step_no = self.state.step + 1
        base = {"stage": self.stage, "replica": self.replica, "step": step_no}

        saved: Dict[tuple, Any] = {}
        accs: List[Any] = [None] * v
        losses: List[float] = []
        busy = 0.0
        for op, i, c in self._ops:
            vs = c * S + self.stage
            firstc, lastc = vs == 0, vs == P - 1
            lane = lanes[c]
            flow = f"mb/{step_no}/{i}/c{c}/r{self.replica}"
            attrs = {**base, "mb": i, "chunk": c}
            fns = self._fns[c]
            if op == F:
                if firstc:
                    x = inputs[i]
                else:
                    r0 = time.monotonic_ns()
                    x = self.fwd_in[c].recv().to(self.device)
                    if fl is not None:
                        fl.record("mpmd.recv_wait", r0, time.monotonic_ns(), lane=lane, attrs={**attrs, "dir": "fwd"})
                saved[(c, i)] = x
                if not lastc:
                    t0 = time.monotonic_ns()
                    y = fns["fwd"](self._chunk_params(c), x)
                    self._sync()
                    t1 = time.monotonic_ns()
                    busy += (t1 - t0) * 1e-9
                    if fl is not None:
                        fl.record("mpmd.fwd", t0, t1, lane=lane, flow=flow, attrs=attrs)
                    s0 = time.monotonic_ns()
                    self.fwd_out[c].send(y)
                    if fl is not None:
                        fl.record("mpmd.send", s0, time.monotonic_ns(), lane=lane, attrs={**attrs, "dir": "fwd"})
                # Last virtual stage: loss + backward run at the B op.
            else:
                assert op == B
                x = saved.pop((c, i))
                if lastc:
                    t0 = time.monotonic_ns()
                    loss, gp, gx = fns["loss_bwd"](self._chunk_params(c), x, targets[i])
                    self._sync()
                    t1 = time.monotonic_ns()
                    busy += (t1 - t0) * 1e-9
                    if fl is not None:
                        fl.record("mpmd.bwd", t0, t1, lane=lane, flow=flow, attrs=attrs)
                    losses.append(float(loss))
                else:
                    r0 = time.monotonic_ns()
                    gy = self.bwd_in[c].recv().to(self.device)
                    t0 = time.monotonic_ns()
                    gp, gx = fns["fwd_bwd"](self._chunk_params(c), x, gy)
                    self._sync()
                    t1 = time.monotonic_ns()
                    busy += (t1 - t0) * 1e-9
                    if fl is not None:
                        fl.record("mpmd.recv_wait", r0, t0, lane=lane, attrs={**attrs, "dir": "bwd"})
                        fl.record("mpmd.bwd", t0, t1, lane=lane, flow=flow, attrs=attrs)
                if not firstc:
                    s0 = time.monotonic_ns()
                    self.bwd_out[c].send(gx)
                    if fl is not None:
                        fl.record("mpmd.send", s0, time.monotonic_ns(), lane=lane, attrs={**attrs, "dir": "bwd"})
                accs[c] = gp if accs[c] is None else self._acc(accs[c], gp)
                gp = gx = None  # the sum holds them now: free the microbatch's

        # Tied-embedding bridge (Megatron embedding allreduce): tok_embed
        # lives on virtual stage 0 (chunk 0 here if stage 0) AND virtual
        # stage P-1 (chunk v-1 if stage S-1); each side contributes a
        # partial gradient. Exchange the two partials over the dedicated
        # edge pair and SUM in f32 — float addition commutes, so both hosts
        # compute bit-identical totals and the two copies stay identical.
        # Send-then-recv is deadlock-free: the directions are separate
        # depth-1 channels and each carries exactly one message per step.
        if self.bridge_out is not None:
            own = 0 if self.first else v - 1
            mine = accs[own]["tok_embed"].to(torch.float32)
            b0 = time.monotonic_ns()
            self.bridge_out.send(mine)
            other = self.bridge_in.recv().to(self.device, torch.float32)
            if fl is not None:
                fl.record("mpmd.bridge", b0, time.monotonic_ns(), lane=lanes[own],
                          attrs={**base, "chunk": own, "dir": "embed"})
            accs[own]["tok_embed"] = mine + other

        # Mean over microbatches (loss = mean of equal-size microbatch
        # means), then the dp-sharded update over the ONE flat space.
        t0 = time.monotonic_ns()
        acc = accs[0] if v == 1 else {f"c{c}": accs[c] for c in range(v)}
        flat_g, _ = zero_flatten(acc)
        del accs, acc
        flat_g = flat_g / torch.tensor(M, dtype=torch.float32, device=flat_g.device)
        new_flat, grad_sumsq = self.opt.step(flat_g)
        del flat_g
        self.params = zero_unflatten(new_flat, self._spec)
        self._sync()
        t1 = time.monotonic_ns()
        if fl is not None:
            fl.record("mpmd.update", t0, t1, lane=lanes[0], attrs=dict(base))
        self.last_update_s = (t1 - t0) * 1e-9
        self.last_busy_s = busy
        try:
            from ...util.metrics import train_metrics

            train_metrics()["train_stage_step_seconds"].observe(
                busy + self.last_update_s, tags={"stage": str(self.stage), "replica": str(self.replica)})
        except Exception:  # noqa: BLE001 — metrics must never fail a step
            pass
        self.state.step += 1
        launches1 = kernel_launches()
        out: Dict[str, Any] = {
            "step": self.state.step,
            "busy_s": busy,
            "update_s": self.last_update_s,
            "grad_sumsq": grad_sumsq,
            "opt_bytes": self.opt.optimizer_bytes,
            "launches": {k: launches1[k] - launches0[k] for k in launches1},
        }
        if self.last:
            out["loss"] = float(np.mean(losses))
        return out

    # ------------------------------------------------------------ checkpoint
    def ckpt_tree(self) -> Dict[str, torch.Tensor]:
        return self.opt.ckpt_tree()

    def load_ckpt(self, state: ElasticState, tree: Dict[str, torch.Tensor]):
        """Adopt a restored optimizer shard (already resharded to this dp
        layout by ShardedCheckpoint.restore) and rebuild the working
        parameters from the gathered master chunks."""
        self.state = state
        self.opt.load_ckpt_tree(tree, t=int(state.extra.get("opt_t", state.step)))
        self.params = zero_unflatten(self.opt.full_flat(), self._spec)

    def params_host(self):
        """CPU copy of the full working parameters (the chunk-namespaced
        tree when interleaved). Collective-free: the working tree is
        already the all-gathered result of the last update."""
        return _tree_map(lambda x: x.detach().to("cpu", copy=True), self.params)

    def chunk_params_host(self, c: int):
        """CPU copy of ONE chunk's param tree (the whole tree at v=1)."""
        return _tree_map(lambda x: x.detach().to("cpu", copy=True), self._chunk_params(c))


def _tree_map(fn, tree):
    """fn over the leaves of a (nested) dict (the reference's
    jax.tree_util.tree_map on the param trees)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
