"""MPMDTrainer — the cluster MPMD pipeline, composed with elastic (port of
the reference's `ray_tpu/train/mpmd/trainer.py`).

Topology: S stages x dp replicas = S*dp gang actors. Replica r of stage s
pipes activations to replica r of stage s+1 (and grads back) over
compiled-DAG edge channels (`dag.compiled.make_edge_channel`: shm seqlock
on a shared node, persistent TCP across nodes), with bulk tensors riding
arena segments + span pulls (`mpmd.transport`). Each stage's dp replicas
form one host-plane collective group for the ZeRO update.

Elastic composition (the elastic layer's machinery, extended; the reference
names its own history here):
  * the GangSupervisor watches ALL S*dp actors through the controller death
    feed; any member death (or a failed step RPC) aborts the WHOLE mesh —
    every stage collective group is aborted so no survivor waits out a
    rendezvous round on a dead peer, then the actors are killed and the
    channels destroyed;
  * the restart policy (budget + backoff) is the supervisor's; after the
    backoff the pipeline RESHAPES: dp is re-picked from currently-feasible
    capacity within [dp_min, dp_max] (stage count S is fixed — stage splits
    cannot change across a reshape, see ElasticState.check_pipeline);
  * stage-local checkpoint shards (`elastic.stage_root` layout, one
    AsyncShardWriter per replica with world=dp) restore at the pipeline's
    COMMON committed step (`latest_common_committed`), resharding each
    stage's flat optimizer chunks across the new dp width with the existing
    axis-0 machinery. The step counter continues exactly where the commit
    left it.

The port's stage actors (the reference's ask for CPUs) are GPU workers
(`MPMDOptions.num_gpus_per_replica`,
1/(S*dp) of the card when the whole pipeline shares one) running their
StageRunner on `MPMDOptions.device` (the card unless asked for the CPU);
each step's history entry also keeps every replica's own metrics
(`replicas`: busy and update seconds, kernel launches, wire bytes).
"""

from __future__ import annotations

import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ...dag.compiled import ChannelHostMixin
from ..config import FailureConfig, RunConfig, ScalingConfig

logger = logging.getLogger(__name__)


@dataclass
class MPMDOptions:
    num_stages: int = 2
    dp: int = 1
    dp_min: Optional[int] = None      # elasticity band for reshapes
    dp_max: Optional[int] = None
    num_microbatches: int = 2
    num_chunks: int = 1               # v model chunks per stage (interleaved
                                      # 1F1B; v>1 needs M % S == 0)
    wire_dtype: str = "f32"           # activation/grad wire: "f32" | "bf16"
    send_depth: int = 2               # per-edge send ring (1 = synchronous)
    zero: bool = True                 # ZeRO sharded update vs replicated
    lr: float = 1e-3
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    seed: int = 0
    ckpt_every: int = 1               # steps between async stage saves
    step_timeout_s: float = 120.0     # driver-side deadline per step RPC
    channel_timeout_s: float = 120.0  # edge send/recv deadline in the actors
    inline_max_bytes: int = 256 * 1024
    channel_buffer_bytes: int = 1 << 20
    num_cpus_per_replica: float = 1.0
    # The port's stage actors are GPU workers (the reference's ask for CPUs
    # only, `ray_tpu/train/mpmd/trainer.py:66`, `:347`): the GPU share of
    # each replica (1/(S*dp) when the pipeline shares one card; 0 = a CPU
    # worker), and the device its runner uses (None: the card).
    num_gpus_per_replica: float = 1.0
    device: Optional[str] = None

    def band(self) -> "tuple[int, int]":
        hi = self.dp if self.dp_max is None else self.dp_max
        lo = hi if self.dp_min is None else self.dp_min
        return max(1, min(lo, hi)), hi


class _StageReplica(ChannelHostMixin):
    """Gang actor hosting one (stage, dp-rank) StageRunner. The channel
    construction surface (node_id/bind_tcp_channel/create_shm_channel)
    comes from the compiled-DAG mixin so `make_edge_channel` binds edges in
    this process exactly as it does for DAG stage hosts."""

    def __init__(self, payload: bytes, stage_params=None):
        import cloudpickle

        self._opts = cloudpickle.loads(payload)
        # The stage's param slices as numpy arrays, from the object store
        # (the reference ships them inside the payload, `:332-333`; a
        # llama-7b stage's 2 GB would not fit one task message).
        self._opts["stage_params"] = stage_params
        self._runner = None
        self._writer = None

    def pid(self) -> int:
        import os

        return os.getpid()

    def setup(self, edges_payload: bytes, restore_step: Optional[int]) -> int:
        """Join the stage dp group, build the runner, bind edges, restore.
        Returns the step to resume from (0 on a fresh run)."""
        import cloudpickle

        from ... import collective
        from ..elastic import AsyncShardWriter, ShardedCheckpoint
        from .stage import StageRunner
        from .transport import ActTransport, ChannelEdge
        from .zero import SoloComm, StoreDpComm

        o = self._opts
        edges = cloudpickle.loads(edges_payload)
        if o["dp"] > 1:
            collective.init_collective_group(
                o["dp"], o["dp_rank"], group_name=o["group_name"]
            )
            comm = StoreDpComm(o["group_name"], o["dp"], o["dp_rank"])
        else:
            comm = SoloComm()
        cfg = o["cfg"]
        v = o.get("num_chunks", 1)
        # Only THIS stage's parameter slices ever land in this process —
        # the driver initialized the full tree once and shipped slices.
        self._runner = StageRunner(
            cfg, o["stage"], o["num_stages"], o["num_microbatches"],
            _as_tensors(o.pop("stage_params")), comm, replica=o["dp_rank"],
            num_chunks=v, zero=o["zero"],
            lr=o["lr"], betas=o["betas"], eps=o["eps"],
            weight_decay=o["weight_decay"],
            device=o["device"],  # the port's (reference: jax's default device, `:116-122`)
        )
        transport = ActTransport(
            inline_max_bytes=o["inline_max_bytes"],
            timeout_s=o["channel_timeout_s"],
            wire_dtype=o.get("wire_dtype", "f32"),
        )
        self._transport = transport
        self._bridge_transport = None  # the port's: run_step reports its bytes (reference: none)
        # The bridge carries gradients FOR the update — it never rides the
        # lossy wire, so it gets its own f32 transport.
        bridge_transport = ActTransport(
            inline_max_bytes=o["inline_max_bytes"],
            timeout_s=o["channel_timeout_s"],
        )
        if edges.get("bridge_out") is not None:
            # Its bytes go into run_step's metrics (the port's; reference: none).
            self._bridge_transport = bridge_transport

        def edge(ch, tr=transport):
            return (
                ChannelEdge(
                    ch, tr, timeout_s=o["channel_timeout_s"],
                    send_depth=o.get("send_depth", 1),
                )
                if ch is not None else None
            )

        def chunk_edges(key):
            chs = edges.get(key) or [None] * v
            return [edge(ch) for ch in chs]

        self._runner.bind_edges(
            fwd_in=chunk_edges("fwd_in"),
            fwd_out=chunk_edges("fwd_out"),
            bwd_in=chunk_edges("bwd_in"),
            bwd_out=chunk_edges("bwd_out"),
            bridge_out=edge(edges.get("bridge_out"), bridge_transport),
            bridge_in=edge(edges.get("bridge_in"), bridge_transport),
        )
        self._writer = AsyncShardWriter(
            o["stage_root"], o["dp_rank"], o["dp"], gen=o["gen"],
            mode="sharded" if o["zero"] else "replicated",
        )
        if restore_step is not None:
            found = ShardedCheckpoint.restore(
                o["stage_root"], o["dp_rank"], o["dp"], step=restore_step
            )
            if found is None:
                raise RuntimeError(
                    f"stage {o['stage']} rank {o['dp_rank']}: committed "
                    f"step {restore_step} vanished before restore"
                )
            state, tree = found
            state.check_pipeline(
                o["stage"], o["num_stages"], o.get("num_chunks", 1)
            )
            self._runner.load_ckpt(state, tree)
        return self._runner.state.step

    def run_step(self, tokens: Optional[np.ndarray], save: bool) -> Dict[str, Any]:
        o = self._opts
        metrics = self._runner.run_step(tokens)
        # The edges' byte counters so far (the port's; reference: only
        # through transport_stats, `ray_tpu/train/mpmd/trainer.py:192-194`).
        metrics["wire"] = self.transport_stats()
        if self._bridge_transport is not None:
            metrics["bridge"] = self._bridge_transport.all_stats()
        if save:
            st = self._runner.state
            st.record_pipeline(
                o["stage"], o["num_stages"], o.get("num_chunks", 1)
            )
            st.extra["opt_t"] = self._runner.opt.t
            self._writer.save(st.step, self._runner.ckpt_tree(), st)
        return metrics

    def flush(self, timeout: float = 60.0) -> bool:
        return self._writer.flush(timeout) if self._writer is not None else True

    def transport_stats(self) -> Dict[str, int]:
        t = getattr(self, "_transport", None)
        return t.all_stats() if t is not None else {}


def _as_tensors(tree):
    """numpy slices (one dict, or a list of per-chunk dicts) -> CPU tensors
    (the port's; the reference's runner takes the arrays)."""
    import torch

    if isinstance(tree, (list, tuple)):
        return [_as_tensors(t) for t in tree]
    return {k: torch.from_numpy(np.asarray(a)) for k, a in tree.items()}


class _MPMDGang:
    """The supervisor-facing gang shim: S*dp actors + their edges/groups."""

    def __init__(self, actors, channels, groups):
        self.actors = actors            # {(stage, rank): handle}
        self.channels = channels
        self.groups = groups

    def actor_ids(self) -> List[str]:
        return [a._id.hex() for a in self.actors.values()]

    def shutdown(self):
        from ...core import api
        from ... import collective

        for g in self.groups:
            try:
                collective.abort_collective_group(g, timeout=5.0)
            except Exception:  # noqa: BLE001
                pass
        for a in self.actors.values():
            try:
                api.kill(a)
            except Exception:  # noqa: BLE001
                pass
        for g in self.groups:
            try:
                collective.destroy_collective_group(g)
            except Exception:  # noqa: BLE001
                pass
        for ch in self.channels:
            try:
                ch.destroy()
            except Exception:  # noqa: BLE001
                pass


class MPMDGangError(RuntimeError):
    pass


class MPMDTrainer:
    """Drive an MPMD pipeline to `total_steps`, elastically.

    `batch_fn(step) -> np.ndarray [B, S+1]` supplies the global token batch
    for a step (deterministic in `step` for exact resume trajectories); B
    must divide by dp_max * num_microbatches, and reshapes only ever pick
    dp values that DIVIDE dp_max (`_pick_dp`), so every reachable width
    shards it evenly.
    """

    def __init__(
        self,
        cfg,
        options: MPMDOptions,
        total_steps: int,
        batch_fn: Callable[[int], np.ndarray],
        run_config: Optional[RunConfig] = None,
        experiment_name: str = "mpmd",
    ):
        from ...device import resolve_device  # the port's (reference: jax's device)
        from ...models import gpt
        from .schedule import build_interleaved_1f1b

        # The port's: without a card this raises unless asked for the CPU
        # (reference: no device option).
        resolve_device(options.device)
        gpt.check_mpmd_partitionable(
            cfg, options.num_stages, options.num_chunks
        )
        # Validates (S, M, v) — interleaving needs M % S == 0 — before any
        # actor spawns.
        build_interleaved_1f1b(
            0, options.num_stages, options.num_microbatches,
            options.num_chunks,
        )
        lo, hi = options.band()
        if not lo <= options.dp <= hi or hi % options.dp != 0:
            # Same contract _pick_dp enforces for reshaped widths: the
            # batch is sized for dp_max * M, so the INITIAL dp must divide
            # dp_max too — failing here beats spawning S*dp actors into a
            # guaranteed first-step ValueError.
            raise ValueError(
                f"dp={options.dp} must lie in [{lo}, {hi}] and divide "
                f"dp_max={hi} (batch divisibility contract)"
            )
        self.cfg = cfg
        self.opts = options
        self.total_steps = total_steps
        self.batch_fn = batch_fn
        self.run_config = run_config or RunConfig()
        self.experiment_name = experiment_name
        self.root = None  # resolved at fit()
        self.gang: Optional[_MPMDGang] = None
        self.dp = options.dp
        self._supervisor = None

    # ------------------------------------------------------------- spawn
    def _spawn(self, dp: int, restore_step: Optional[int]):
        """Create the S x dp gang, its edge channels, and the per-stage dp
        groups; run setup (join + restore) on every replica. Returns
        (gang, start_step)."""
        import cloudpickle

        from ...core import api
        from ...core.runtime_context import get_runtime_context
        from ...dag.compiled import make_edge_channel
        from ... import collective
        from ..elastic.ckpt import stage_root as stage_root_of

        # (the reference imports jax here)
        from ...models import gpt

        o, S, v = self.opts, self.opts.num_stages, self.opts.num_chunks
        gen = uuid.uuid4().hex[:8]
        remote_cls = api.remote(_StageReplica)
        # The full parameter tree is materialized ONCE, here on the driver,
        # and each replica receives only ITS stage's chunk slices — S*dp
        # gang actors must never each allocate the whole model just to
        # throw most of it away (at GPT-J scale that transient would OOM
        # exactly the hosts the ZeRO sharding is sized for).
        # The port seeds on the CPU (the same params whatever the actors'
        # device), and puts each stage's slices in the object store once,
        # as numpy arrays (carried out of band), for its dp replicas to
        # take as an argument (reference: numpy slices in each payload,
        # `:315-327`, `:349-350`).
        params = gpt.init_params(self.cfg, seed=o.seed, device="cpu")
        stage_refs = [
            api.put([
                {
                    k: t.numpy()
                    for k, t in gpt.extract_stage_params(
                        params, self.cfg, s, S, num_chunks=v, chunk=c
                    ).items()
                }
                for c in range(v)
            ] if v > 1 else {
                k: t.numpy()
                for k, t in gpt.extract_stage_params(params, self.cfg, s, S).items()
            })
            for s in range(S)
        ]
        del params  # reference: params_np
        actors: Dict[tuple, Any] = {}
        for s in range(S):
            for r in range(dp):
                payload = cloudpickle.dumps(dict(
                    cfg=self.cfg, stage=s, num_stages=S, dp=dp, dp_rank=r,
                    # (stage_params: an argument of its own, see above;
                    # the reference puts them here)
                    num_microbatches=o.num_microbatches,
                    num_chunks=v, wire_dtype=o.wire_dtype,
                    send_depth=o.send_depth, zero=o.zero,
                    lr=o.lr, betas=o.betas, eps=o.eps,
                    weight_decay=o.weight_decay, seed=o.seed,
                    group_name=f"mpmd-{self.experiment_name}-{gen}-s{s}",
                    stage_root=stage_root_of(self.root, s), gen=gen,
                    inline_max_bytes=o.inline_max_bytes,
                    channel_timeout_s=o.channel_timeout_s,
                    device=o.device,
                ))
                # GPU workers (reference: CPUs only, `:346-348`).
                actors[(s, r)] = remote_cls.options(
                    num_cpus=o.num_cpus_per_replica,
                    num_gpus=o.num_gpus_per_replica,
                ).remote(payload, stage_refs[s])  # reference: the payload only
        groups = [
            f"mpmd-{self.experiment_name}-{gen}-s{s}" for s in range(S)
        ] if dp > 1 else []
        for s in range(S):
            if dp > 1:
                collective.create_collective_group(
                    [actors[(s, r)] for r in range(dp)], dp, list(range(dp)),
                    group_name=groups[s],
                )

        # Edge channels: replica r of stage s -> replica r of stage s+1
        # (fwd) and back (bwd) PER CHUNK, plus the wrap edges chunk c of
        # stage S-1 -> chunk c+1 of stage 0 when interleaved, plus the
        # tied-embedding bridge pair between the boundary stages — all
        # built with the compiled-DAG channel chooser so same-node edges
        # ride shm and cross-node edges ride TCP.
        driver_node = get_runtime_context().get_node_id()
        nodes = {
            key: nid for key, nid in zip(
                actors, api.get([a.node_id.remote() for a in actors.values()])
            )
        }
        channels = []
        edges: Dict[tuple, Dict[str, Any]] = {
            key: {
                "fwd_in": [None] * v, "fwd_out": [None] * v,
                "bwd_in": [None] * v, "bwd_out": [None] * v,
            }
            for key in actors
        }

        def connect(src, dst, kind, src_c, dst_c):
            ch = make_edge_channel(
                o.channel_buffer_bytes, nodes[src], [nodes[dst]], 1,
                actors[src], driver_node,
            )
            channels.append(ch)
            edges[src][f"{kind}_out"][src_c] = ch
            edges[dst][f"{kind}_in"][dst_c] = ch.with_reader_slot(0)

        for r in range(dp):
            for c in range(v):
                for s in range(S - 1):
                    connect((s, r), (s + 1, r), "fwd", c, c)
                    connect((s + 1, r), (s, r), "bwd", c, c)
            # Wrap: virtual stage c*S + (S-1) feeds (c+1)*S + 0 — the
            # forward leaves stage S-1's chunk c into stage 0's chunk c+1
            # (and the grad comes back).
            for c in range(v - 1):
                connect((S - 1, r), (0, r), "fwd", c, c + 1)
                connect((0, r), (S - 1, r), "bwd", c + 1, c)
            if self.cfg.tie_embeddings and S > 1:
                b_fwd = make_edge_channel(
                    o.channel_buffer_bytes, nodes[(0, r)],
                    [nodes[(S - 1, r)]], 1, actors[(0, r)], driver_node,
                )
                b_bwd = make_edge_channel(
                    o.channel_buffer_bytes, nodes[(S - 1, r)],
                    [nodes[(0, r)]], 1, actors[(S - 1, r)], driver_node,
                )
                channels.extend([b_fwd, b_bwd])
                edges[(0, r)]["bridge_out"] = b_fwd
                edges[(S - 1, r)]["bridge_in"] = b_fwd.with_reader_slot(0)
                edges[(S - 1, r)]["bridge_out"] = b_bwd
                edges[(0, r)]["bridge_in"] = b_bwd.with_reader_slot(0)

        gang = _MPMDGang(actors, channels, groups)
        try:
            steps = api.get(
                [
                    actors[key].setup.remote(
                        cloudpickle.dumps(edges[key]), restore_step
                    )
                    for key in actors
                ],
                timeout=o.step_timeout_s * 2 + 120,
            )
        except Exception as e:  # noqa: BLE001 — a member died mid-setup
            gang.shutdown()
            raise MPMDGangError(f"gang setup failed: {e!r}") from e
        start = max(steps)
        if len(set(steps)) > 1:
            gang.shutdown()
            raise MPMDGangError(
                f"stage replicas restored inconsistent steps {steps}"
            )
        return gang, start

    # --------------------------------------------------------------- fit
    def fit(self) -> Dict[str, Any]:
        from ...core import api  # noqa: F401 — runtime must be initialized
        from ..elastic import GangSupervisor

        o, S = self.opts, self.opts.num_stages
        self.root = self.run_config.resolve_storage()
        lo, hi = o.band()
        # The GPU share joins the ask (reference: CPUs only, `:450`).
        resources = {"CPU": o.num_cpus_per_replica}
        if o.num_gpus_per_replica > 0:
            resources["GPU"] = o.num_gpus_per_replica
        supervisor = GangSupervisor(
            ScalingConfig(
                num_workers=S * self.dp,
                min_workers=S * lo,
                max_workers=S * hi,
                resources_per_worker=resources,  # reference: CPU only
            ),
            self.run_config.failure_config or FailureConfig(),
            experiment_name=self.experiment_name,
        )
        self._supervisor = supervisor
        history: List[Dict[str, Any]] = []
        recovery_t0: Optional[float] = None
        try:
            return self._fit_loop(supervisor, history, recovery_t0, lo, hi)
        except BaseException:
            # A non-gang exception (config error, KeyboardInterrupt) must
            # not leak a live S x dp gang + watch thread behind the raise.
            supervisor.stop_watch()
            if self.gang is not None:
                self.gang.shutdown()
                self.gang = None
            raise

    def _fit_loop(self, supervisor, history, recovery_t0, lo, hi):
        from ..elastic import latest_common_committed

        S = self.opts.num_stages
        while True:
            try:
                found = latest_common_committed(self.root, S)
                restore_step = found[0] if found else None
                self.gang, start = self._spawn(self.dp, restore_step)
                # The supervisor owns group aborts on failure: every
                # stage's dp rendezvous is interrupted inside abort_mesh
                # (its _collective_group accepts the list), so survivors
                # never wait out a round on a dead peer.
                supervisor.watch(
                    self.gang, collective_group=list(self.gang.groups)
                )
                if recovery_t0 is not None:
                    supervisor.record_recovery(time.monotonic() - recovery_t0)
                    recovery_t0 = None
                self._run_steps(start, history, supervisor)
                self._finish()
                supervisor.stop_watch()
                return {
                    "history": history,
                    "error": None,
                    "attempts": supervisor.attempts,
                    "dp": self.dp,
                }
            except MPMDGangError as e:
                if recovery_t0 is None:
                    recovery_t0 = time.monotonic()
                supervisor.abort_mesh(self.gang)
                self.gang = None
                decision = supervisor.on_failure(str(e))
                if decision.stop:
                    logger.error(
                        "MPMD gang failed permanently after %d attempt(s): %s",
                        supervisor.attempts, e,
                    )
                    return {
                        "history": history,
                        "error": str(e),
                        "attempts": supervisor.attempts,
                        "dp": self.dp,
                    }
                logger.warning(
                    "MPMD gang failure (%s) — restart %d after %.1fs",
                    e, supervisor.attempts, decision.backoff_s,
                )
                if decision.backoff_s > 0:
                    time.sleep(decision.backoff_s)
                # RESHAPE: re-pick dp from what the cluster can place NOW
                # (measured after the backoff so the dead gang's resources
                # have drained), clamped to the configured band AND to
                # divisors of dp_max — the batch contract is divisibility
                # by dp_max * M, which only guarantees divisibility for dp
                # that divide dp_max (dp=3 in a [1,4] band would crash the
                # step loop on a batch sized for 4).
                world = supervisor.plan_world_size()
                new_dp = self._pick_dp(
                    world // S if world else self.dp, lo, hi
                )
                if new_dp != self.dp:
                    logger.warning(
                        "MPMD pipeline reshapes: dp %d -> %d", self.dp, new_dp
                    )
                    self.dp = new_dp

    @staticmethod
    def _pick_dp(feasible: int, lo: int, hi: int) -> int:
        """Largest dp in [lo, hi] that fits `feasible` AND divides the band
        ceiling (see reshape comment). The candidate set is never empty (hi
        divides itself); when even the smallest candidate exceeds feasible
        it is returned anyway — the spawn then fails and consumes restart
        budget honestly rather than deadlocking the policy loop."""
        candidates = [d for d in range(lo, hi + 1) if hi % d == 0]
        fitting = [d for d in candidates if d <= feasible]
        return max(fitting) if fitting else min(candidates)

    def _run_steps(self, start: int, history, supervisor):
        from ...core import api

        o, S, dp = self.opts, self.opts.num_stages, self.dp
        for step in range(start, self.total_steps):
            reason = supervisor.failure()
            if reason:
                raise MPMDGangError(f"gang member died ({reason})")
            batch = np.asarray(self.batch_fn(step))
            if batch.shape[0] % (dp * o.num_microbatches) != 0:
                raise ValueError(
                    f"batch {batch.shape[0]} not divisible by dp*microbatches "
                    f"({dp}*{o.num_microbatches})"
                )
            slices = np.array_split(batch, dp)
            save = (step + 1) % max(1, o.ckpt_every) == 0
            refs, keys = [], []
            for (s, r), actor in self.gang.actors.items():
                tokens = slices[r] if (s == 0 or s == S - 1) else None
                refs.append(actor.run_step.remote(tokens, save))
                keys.append((s, r))
            t0 = time.monotonic()
            out = self._get_step_results(refs, step, supervisor)
            wall = time.monotonic() - t0
            metrics = dict(zip(keys, out))
            last = [metrics[(S - 1, r)] for r in range(dp)]
            per_stage0 = [metrics[(s, 0)] for s in range(S)]
            # Busy = stage compute + optimizer update — the same numerator
            # the local harness and flight.pipeline_report use, so all
            # three bubble sources stay directly comparable.
            busy = sum(
                m["busy_s"] + m.get("update_s", 0.0)
                for m in metrics.values()
            )
            bubble = max(0.0, 1.0 - busy / (wall * S * dp))
            history.append({
                "step": step + 1,
                "loss": float(np.mean([m["loss"] for m in last])),
                "grad_norm": float(
                    np.sqrt(sum(m["grad_sumsq"] for m in per_stage0))
                ),
                "wall_s": wall,
                "bubble_frac": bubble,
                "opt_bytes_per_replica": max(
                    m["opt_bytes"] for m in metrics.values()
                ),
                "dp": dp,
                # Each replica's own metrics (the port's; reference: only
                # the aggregates above, `:583-595`).
                "replicas": {f"s{s}r{r}": m for (s, r), m in metrics.items()},
            })
            try:
                # The trainer's wall-clock aggregate; the span-derived
                # attribution (flight.pipeline_report, source="flight")
                # cross-checks it from the stage actors' slot spans.
                from ...util.metrics import train_metrics

                train_metrics()["train_pipeline_bubble_fraction"].set(
                    bubble, tags={"source": "trainer"})
            except Exception:  # noqa: BLE001
                pass

    def _get_step_results(self, refs, step: int, supervisor):
        """Collect one step's replica results in SHORT slices, consulting
        the supervisor between them: a member death detected through the
        controller feed aborts the step within the poll window instead of
        waiting out the full step deadline on RPCs that will never
        complete."""
        from ...core import api
        from ...core.exceptions import GetTimeoutError

        deadline = time.monotonic() + self.opts.step_timeout_s
        while True:
            reason = supervisor.failure()
            if reason:
                raise MPMDGangError(f"gang member died ({reason})")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise MPMDGangError(
                    f"step {step} timed out after "
                    f"{self.opts.step_timeout_s:.0f}s"
                )
            try:
                return api.get(refs, timeout=min(2.0, remaining))
            except GetTimeoutError:
                continue
            except Exception as e:  # noqa: BLE001 — a member died
                raise MPMDGangError(f"step {step} failed: {e!r}") from e

    def _finish(self):
        from ...core import api

        try:
            api.get(
                [a.flush.remote() for a in self.gang.actors.values()],
                timeout=120,
            )
        finally:
            self.gang.shutdown()
            self.gang = None
