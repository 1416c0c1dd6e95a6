"""Controller — head process combining the reference's GCS + raylet roles.

Reference analogs:
  * cluster/actor/PG/object directories — GCS (`src/ray/gcs/gcs_server`),
    whose hot tables are INDEPENDENT SHARDED TABLES — mirrored here by
    `control_shards.py`
  * task queueing, dispatch, worker pool  — raylet (`src/ray/raylet/node_manager.cc`,
    `worker_pool.h:156`, `local_task_manager.cc`)
  * object lifetime/spill — `LocalObjectManager` + plasma eviction

Redesign rationale (TPU-first): ONE head process, MANY event loops. The hot
actor/lease/worker directories are partitioned by ID hash into N shards
(`controller_shards`, crc32 % N); each shard's own event loop is the single
writer for its actors' delivery plane (send queues, pumps, inflight maps),
so a 2,000-actor wave's per-call bookkeeping never serializes behind the
scheduler. The MAIN loop keeps what is inherently global: scheduling +
node capacity, the object directory, placement groups, and the thin
cross-shard coordination layer (named-actor registry, FT snapshots,
timeline). Cross-loop traffic is marshaled, never locked-and-shared — see
docs/SHARDED_CONTROL_PLANE.md for the ownership rules and invariants.
The multi-node seam is unchanged: remote node daemons join through
`register_node`, keeping scheduler state per-node the way
`ClusterResourceManager` does.

Data plane stays OUT of this process: objects ride named shm segments
(store.py); the controller holds only locations, sizes, refstate, and waiters.

Fault model (docs/CONTROL_PLANE_HA.md): head death is a recoverable event,
not a cluster funeral. Every state-mutating transition is written ahead to
a CRC-guarded, fsync-batched event log (event_log.py); the periodic
checkpoint compacts it. A restarted head restores checkpoint + replay,
re-binds its port, and re-adopts surviving workers/agents as they
reconnect — actors, the data plane, and in-flight direct calls never
touch the head on their hot paths and keep running through the outage.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import subprocess
import sys
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import cloudpickle

from . import serialization, store
from .exceptions import (
    ActorDiedError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from . import config as rt_config
from .devices import ACCELERATOR, pin_worker_devices  # the GPU worker kind (reference: none)
from .rpc import Connection, read_msg
from .rpc import auth_token as rpc_auth_token, open_rpc_connection
from .ids import ObjectID
from .task_spec import (
    spec_from_proto_bytes,
    spec_to_proto_bytes,
    DefaultSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
    TaskSpec,
    TaskType,
)

IDLE = "idle"
BUSY = "busy"
STARTING = "starting"
ACTOR = "actor"
DEAD = "dead"

# ---------------------------------------------- prometheus exposition utils
# Hoisted to module level: compiled ONCE, not re-imported/recompiled on
# every /metrics scrape.
import re as _re  # noqa: E402

_METRIC_NAME_RE = _re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_KEY_RE = _re.compile(r"[^a-zA-Z0-9_]")


def _san_name(name: str) -> str:
    return _METRIC_NAME_RE.sub("_", name)


def _esc_label(v) -> str:  # prometheus exposition label-value escaping
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _esc_help(v) -> str:  # HELP lines escape backslash + newline only
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _format_tags(tags) -> str:
    return ",".join(
        f'{_LABEL_KEY_RE.sub("_", k)}="{_esc_label(v)}"' for k, v in tags
    )


def _format_le(b: float) -> str:
    # 0.25 -> "0.25", 1.0 -> "1.0" (float repr is stable and scrape-safe)
    return repr(float(b))
# Leased to a submitter for the direct task path (reference: worker leases,
# `direct_task_transport.cc:135` — steady-state submissions bypass the
# scheduler entirely; the controller only grants/returns the lease).
LEASED = "leased"


HEAD_NODE = "node0"


def _task_env_key(spec) -> str:
    """Isolation hash of the task's runtime_env ("" = plain pool)."""
    renv = spec.options.runtime_env
    if not renv:
        return ""
    from ..runtime_env.isolation import isolation_key

    return isolation_key(renv)


@dataclass
class WorkerState:
    worker_id: str
    conn: Optional[Connection] = None
    pid: int = 0
    state: str = STARTING
    current_task: Optional[str] = None  # task hex
    actor_hex: Optional[str] = None
    assigned: Dict[str, float] = field(default_factory=dict)
    # When set, `assigned` was carved from this PG bundle, not node capacity.
    assigned_pg: Optional[Tuple[str, int]] = None
    # Lease reuse (reference: cached leases, `direct_task_transport.cc:135`):
    # one same-shape argless task queued BEHIND current_task on this worker,
    # promoted at task_done without a scheduler round trip.
    prefetch_task: Optional[str] = None
    # Task hex a reclaim push is in flight for (see
    # _reclaim_stranded_prefetches) — suppresses duplicate reclaims; cleared
    # by the worker's task_dropped push or by task_done (reclaim lost).
    reclaiming_task: Optional[str] = None
    blocked: bool = False
    node_id: str = HEAD_NODE
    has_tpu: bool = False
    # Isolation hash (runtime_env conda/container — `isolation_key`): tasks
    # only dispatch onto workers whose env_key matches; "" = plain pool.
    env_key: str = ""
    # Direct task plane: the worker's own listener for submitter→worker
    # pushes (reference: core-worker gRPC server for PushNormalTask).
    direct_addr: str = ""
    # conn_id of the lease holder while state == LEASED.
    leased_to: Optional[int] = None
    # A revoke push is in flight to the lease holder.
    revoking: bool = False
    # Killed by the memory monitor — labels the death error as OOM.
    oom_killed: bool = False


@dataclass
class NodeState:
    """Per-node view (reference analog: `NodeResources` in
    `cluster_resource_data.h:289` + the GCS node directory). The head node
    (`node0`) is the controller's own machine slice — `conn is None`; remote
    nodes are `node_agent.py` daemons."""

    node_id: str
    conn: Optional[Connection] = None
    fetch_addr: str = ""
    bulk_addr: str = ""
    # Two-level scheduling (reference: ClusterTaskManager picks the node,
    # LocalTaskManager owns the local queue + worker grant —
    # `scheduling/cluster_task_manager.h:42` / `local_task_manager.cc:1`):
    # agents that run a LocalDispatcher accept queued-task handoffs and keep
    # dispatching them to leased local workers with no head involvement.
    dispatch: bool = False
    handoff_inflight: int = 0
    total: Dict[str, float] = field(default_factory=dict)
    available: Dict[str, float] = field(default_factory=dict)
    session_tag: str = ""
    alive: bool = True
    spawning: int = 0
    spawning_tpu: int = 0
    object_store_memory: int = 0
    # Node labels (reference: `NodeLabelSchedulingStrategy` label matching).
    labels: Dict[str, str] = field(default_factory=dict)
    # Last time resources were acquired/released here — drives the
    # autoscaler's idle-node detection (reference: `LoadMetrics`
    # `load_metrics.py:63` last_used_time_by_ip).
    last_active: float = field(default_factory=time.monotonic)
    # Latest cpu/mem/disk/TPU sample (reference: reporter_agent node stats).
    sys_metrics: Dict[str, float] = field(default_factory=dict)
    # Worker ids the node's agent spawned whose process is currently alive
    # (from health-probe replies) — the controller's only liveness signal
    # for agent-spawned isolated workers it has no proc handle for.
    agent_alive_workers: set = field(default_factory=set)

    def utilization(self) -> float:
        fracs = [
            1.0 - self.available.get(k, 0.0) / v
            for k, v in self.total.items()
            if v > 0
        ]
        return max(fracs) if fracs else 0.0


@dataclass
class ObjectState:
    status: str = "pending"  # pending | ready
    inline: Optional[bytes] = None
    # node_id -> shm name on that node (primary + pulled copies).
    locations: Dict[str, str] = field(default_factory=dict)
    spilled_path: Optional[str] = None
    spilled_node: str = HEAD_NODE
    size: int = 0
    last_access: float = 0.0
    events: List[asyncio.Event] = field(default_factory=list)
    # Tasks blocked on this object (by task hex).
    dependents: Set[str] = field(default_factory=set)
    # --- distributed refcount (reference: `reference_count.h:39-52`) ---
    holders: Set[int] = field(default_factory=set)  # conn ids with live refs
    ever_held: bool = False
    pinned: int = 0          # queued/running tasks using this as an arg
    recon_attempts: int = 0  # lineage re-executions tried for this object
    expected: bool = False   # a submitted task will produce this (return id)
    gc_at: float = 0.0       # earliest sweep time once GC-eligible
    # ObjectRefs nested in this value's bytes: pinned for the container's
    # lifetime (reference: `ReferenceCounter::AddNestedObjectIds`).
    contains: List[str] = field(default_factory=list)

    @property
    def shm_name(self) -> Optional[str]:  # head-node name (spill path compat)
        return self.locations.get(HEAD_NODE)

    def is_lost(self) -> bool:
        return (
            self.status == "ready"
            and self.inline is None
            and not self.locations
            and self.spilled_path is None
        )


class _HandoffFence:
    """Direct-channel switch marker riding the actor send queue — duck-typed
    to the TaskSpec fields the queue paths read (drain/unpin are no-ops)."""

    __slots__ = ("token", "arg_refs", "return_ids", "num_returns", "name")

    def __init__(self, token: str):
        self.token = token
        self.arg_refs = []
        self.return_ids = []
        self.num_returns = 0
        self.name = "__handoff_fence__"


@dataclass
class ActorState:
    actor_hex: str
    spec: Optional[TaskSpec] = None  # creation spec kept for restarts
    worker_id: Optional[str] = None
    state: str = "pending"  # pending | alive | restarting | dead
    name: str = ""
    namespace: str = "default"
    handle_bytes: bytes = b""
    restarts_used: int = 0
    # Submission-ordered calls not yet delivered to the worker. A single pump
    # coroutine drains this FIFO so per-actor call order is preserved even
    # when some calls wait on unready args (reference analog: the ordered
    # `ActorSchedulingQueue`). OWNED BY THE ACTOR'S SHARD LOOP: appends and
    # pops are marshaled there (control_shards.py ownership rules).
    send_queue: deque = field(default_factory=deque)
    # Calls delivered to the worker and not yet completed: task hex -> spec.
    # Written by the shard pump, popped by main-loop completion handlers —
    # multi-step sequences take `lock`.
    inflight: Dict[str, TaskSpec] = field(default_factory=dict)
    pump_active: bool = False
    # Awaited on the shard loop; main-loop state transitions wake it via
    # wake() (cross-loop marshal).
    state_event: asyncio.Event = field(default_factory=asyncio.Event)
    detached: bool = False
    init_error: Optional[TaskError] = None
    # Owning shard (set at insert; None only in unit tests that poke state).
    shard: Any = None
    lock: Any = field(default_factory=__import__("threading").Lock)

    def wake(self):
        """Wake a pump blocked on state_event, from any thread."""
        if self.shard is not None and self.shard.loop is not None:
            try:
                self.shard.loop.call_soon_threadsafe(self.state_event.set)
                return
            except RuntimeError:
                pass  # shard loop stopped (shutdown)
        self.state_event.set()


@dataclass
class PendingTask:
    spec: TaskSpec
    deps_remaining: Set[str] = field(default_factory=set)
    retries_left: int = 0
    # Spread/affinity commitment: once a node is chosen, later scheduling
    # passes honor it (otherwise the round-robin re-rolls every pass and the
    # task bounces between half-spawned nodes).
    pinned_node: Optional[str] = None
    # Cached (demand, strategy) signature for the scheduler's no-capacity
    # fast path — building it per scan entry per pass dominated deep-queue
    # profiles (1.6M sorted() calls per 3k tasks). Invalidated when
    # pinned_node changes (it is part of the signature).
    _sig_cache: Optional[tuple] = None
    _sig_pinned: Optional[str] = None

    def sched_sig(self, need_tpu: bool):
        strat = self.spec.options.scheduling_strategy
        if isinstance(strat, SpreadSchedulingStrategy):
            return None  # rotation → per-decision outcomes; never fast-path
        if self._sig_cache is None or self._sig_pinned != self.pinned_node:
            self._sig_cache = (
                tuple(sorted(self.spec.resources.items())),
                type(strat).__name__,
                getattr(strat, "node_id", None),
                getattr(strat, "soft", None),
                tuple(sorted(getattr(strat, "hard", {}).items())),
                need_tpu,
                self.pinned_node,
            )
            self._sig_pinned = self.pinned_node
        return self._sig_cache


class Controller:
    def __init__(
        self,
        num_cpus: float,
        resources: Dict[str, float],
        session_dir: str,
        object_store_memory: Optional[int] = None,
        port: int = 0,
        standalone: bool = False,
    ):
        # standalone: a Cluster-managed controller outlives its drivers
        # (sessions auto-started by ray_tpu_torch.init still die with the driver).
        self.standalone = standalone
        self.session_dir = session_dir
        os.makedirs(session_dir, exist_ok=True)
        self.spill_dir = os.path.join(session_dir, "spill")
        self.port = port
        self.object_store_memory = object_store_memory or int(
            min(
                rt_config.get("object_store_fraction")
                * os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"),
                64 << 30,
            )
        )
        self.store_bytes_used = 0
        self.local_store = store.LocalStore()

        head_total = {"CPU": float(num_cpus), **resources}
        self.head = NodeState(
            node_id=HEAD_NODE,
            total=dict(head_total),
            available=dict(head_total),
            object_store_memory=self.object_store_memory,
        )
        self.nodes: Dict[str, NodeState] = {HEAD_NODE: self.head}
        # In-flight cross-node pulls, deduped: (node_id, object_hex) -> Future.
        self._pulls: Dict[Tuple[str, str], asyncio.Future] = {}
        # Broadcast shaping: active pulls served per source node + waiters
        # parked until a pull completes (new copies appear).
        self._src_active: Dict[str, int] = {}
        self._transfer_waiters: List[asyncio.Future] = []
        # (node_id, started_at, tpu) per in-flight spawn — boot-budget
        # expiry for spawns that die before registering.
        self._spawn_ledger: List[tuple] = []
        # Controller -> agent fetch-server connections (for pulls INTO node0).
        self._fetch_conns: Dict[str, Connection] = {}
        self._spread_rr = 0

        # Lineage: creating TaskSpec per task, enabling lost-object
        # re-execution (reference: `ObjectRecoveryManager::RecoverObject`,
        # `object_recovery_manager.cc:22`; ObjectID encodes TaskID so the
        # lookup is free — `common/id.h:272` property kept by ids.py).
        self.lineage: Dict[str, TaskSpec] = {}
        self._lineage_cap = rt_config.get("lineage_cap")
        self._conn_counter = itertools.count(1)
        # conn_id → live Connection (lease revocation pushes to holders).
        self._conns_by_id: Dict[int, Connection] = {}
        # Direct actor-call handoff fences (h_actor_handoff).
        self._handoff_counter = itertools.count(1)
        self._handoff_waiters: Dict[str, asyncio.Future] = {}
        # Unsatisfied lease requests → autoscaler demand (expires in 5s).
        self._lease_backlog: Dict[tuple, tuple] = {}
        # Worker ids currently LEASED — lets the backlog revoke sweep touch
        # only lease holders instead of scanning the whole worker table
        # every pass (O(W·passes) measured on actor waves).
        self._leased_ids: Set[str] = set()
        # Worker ids with a prefetched task queued (same pattern: the
        # stranded-prefetch sweep is per-pass; self-cleaning against
        # ws.prefetch_task, so a missed clear is harmless).
        self._prefetch_ids: Set[str] = set()
        # Pulsed on every worker registration — parked lease requests and
        # other capacity waiters re-check on it.
        self._worker_arrival = asyncio.Event()
        # Direct tasks currently executing, reported via batched task_events
        # (observability only — the scheduler never touches these).
        self.direct_running: Dict[str, dict] = {}
        self._gc_candidates: Set[str] = set()
        # Reverse index: conn_id -> hex ids it holds (O(refs) disconnects).
        self._conn_refs: Dict[int, Set[str]] = {}
        # (name, tags) -> (value, kind, last_update_ts) — user scalar metrics
        # for /metrics; (name, tags) -> dict for histogram families. Series
        # idle past _metric_staleness_s are dropped at scrape time (gauges
        # from dead replicas/workers must not persist forever).
        self.user_metrics: Dict[Tuple[str, tuple], Tuple[float, str, float]] = {}
        self.user_hists: Dict[Tuple[str, tuple], dict] = {}
        self.user_metric_help: Dict[str, str] = {}
        self._metric_staleness_s = float(
            os.environ.get("RAY_TPU_METRIC_STALENESS_S", 900.0)
        )
        self.metrics_port = 0
        self._metrics_server: Optional[asyncio.base_events.Server] = None

        self.objects: Dict[str, ObjectState] = {}
        # Hot directories, partitioned by ID hash into independent shards
        # (control_shards.py — the GCS-table split): each shard's event
        # loop owns its actors' delivery plane; the tables themselves are
        # structurally mutated only on this (main) loop.
        from .control_shards import ControlShard, ShardedDict

        n_shards = max(1, int(rt_config.get("controller_shards")))
        threaded = bool(rt_config.get("controller_shard_threads"))
        self.shards = [ControlShard(i, threaded=threaded) for i in range(n_shards)]
        self.workers: "ShardedDict" = ShardedDict(self.shards, "workers")
        self.jobs: Dict[str, dict] = {}
        self.streams: Dict[str, dict] = {}  # streaming-generator progress
        self._spec_blobs: Dict[str, bytes] = {}  # snapshot pickle cache
        self.actors: "ShardedDict" = ShardedDict(self.shards, "actors")
        # Cross-shard coordination state (main-loop-owned): the name
        # registry spans shards — exactly one (namespace, name) → one
        # actor in one shard.
        self.named_actors: Dict[Tuple[str, str], str] = {}
        self.pgs: Dict[str, dict] = {}
        self.ready_queue: deque = deque()  # PendingTask with no deps
        self.waiting_tasks: Dict[str, PendingTask] = {}  # task hex -> waiting on deps
        self.running: Dict[str, Tuple[str, PendingTask]] = {}  # task hex -> (worker, pt)
        self.cancelled: Set[str] = set()
        # Explicit capacity requests from `autoscaler.sdk.request_resources`
        # (reference: `python/ray/autoscaler/sdk` → GCS resource_request).
        self._explicit_demands: List[Dict[str, float]] = []
        self.timeline: List[dict] = []
        # Absolute index of timeline[0] — lets poll_events cursors survive
        # truncation (a cursor is "events seen so far", not a list index).
        self._timeline_base = 0
        self.drivers: Set[Connection] = set()
        self._worker_counter = itertools.count()
        # Isolated-worker bookkeeping (runtime_env conda/container):
        # worker_id -> env_key applied at registration; (node, key) ->
        # last spawn time (a monotonic gate so one isolated worker boots
        # per key per node at a time, self-healing if the spawn dies).
        self._worker_env_keys: Dict[str, str] = {}
        # (node, key) -> (last spawn time, worker_id of that attempt)
        self._iso_booting: Dict[Tuple[str, str], Tuple[float, str]] = {}
        # (node, key) -> consecutive spawns that died before registering
        # (wrapper exec'd fine but the env is broken: bad conda env name,
        # unpullable image, ...). Capped — see _spawn_isolated.
        self._iso_attempts: Dict[Tuple[str, str], int] = {}
        # (node_id, env_key) -> error: the isolation binary is missing on
        # that node (sticky; a node gaining conda mid-session must rejoin).
        self._iso_unavailable: Dict[Tuple[str, str], str] = {}
        self._max_workers = max(int(num_cpus) * rt_config.get("max_workers_per_cpu"), 8)
        self._min_workers = 2
        self._server: Optional[asyncio.base_events.Server] = None
        self._scheduling = False
        self._schedule_again = False
        # Deferred-scheduling coalescing: _schedule() marks a pass pending
        # and runs it once per event-loop drain (see _schedule_tick) — a
        # 2,000-worker registration storm triggers a handful of passes
        # instead of one full pass per message (r6: 1,564 passes for a
        # 300-actor wave, ~2s of pure pass overhead).
        self._schedule_soon = False
        self._shutdown_event = asyncio.Event()
        self._worker_procs: Dict[str, subprocess.Popen] = {}
        self._forkserver = None  # set in start()
        # Write-ahead event log (event_log.py): every state-mutating
        # transition appends; restore = checkpoint + replay. None when
        # disabled (driver-owned session / memory:// backend).
        self._wal = None
        self._recoveries_total = 0

    # ------------------------------------------------------------ lifecycle
    _SNAPSHOT_KEY = "controller_state"

    @property
    def _gcs_store(self):
        """Pluggable metadata backend (reference: `src/ray/gcs/store_client`
        — InMemory vs Redis). memory:// disables controller FT; file://
        (default, session dir) survives kill -9; a shared filesystem gives
        off-box durability in Redis's role."""
        if getattr(self, "_gcs_store_client", None) is None:
            from .store_client import make_store_client

            self._gcs_store_client = make_store_client(
                rt_config.get("gcs_storage"), self.session_dir
            )
        return self._gcs_store_client

    async def start(self, restore: bool = False):
        # Shard plumbing: inline shards execute on this loop; threaded
        # shards already run their own (control_shards.py).
        self._main_loop = asyncio.get_running_loop()
        for sh in self.shards:
            sh.attach_main_loop(self._main_loop)
        self._open_wal()
        # _restore_state handles missing/corrupt state itself — checkpoint
        # read (if any) + WAL replay past it.
        restored = restore
        if restored:
            t0 = time.monotonic()
            restored = self._restore_state()  # adopts the dead session's tag
            if restored:
                self._recoveries_total += 1
                self._self_inc("controller_recoveries_total", 1.0)
                self._self_observe(
                    "controller_recovery_seconds", time.monotonic() - t0
                )
        if not restored:
            store.set_session_tag(str(os.getpid()))
            store.cleanup_stale_segments()
            # Native arena (plasma-equivalent): the controller owns the
            # segment; drivers/workers attach after the session-tag handshake.
            self.local_store = store.make_store(
                create_arena=True, arena_capacity=self.object_store_memory
            )
        # Real-host networking (reference: node_ip_address plumbing,
        # `services.py:295-305`): advertise node_ip, listen on bind_address.
        self.node_ip = rt_config.get("node_ip")
        bind = rt_config.get("bind_address") or self.node_ip
        self._server = await asyncio.start_server(
            self._on_connection, host=bind, port=self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if not restored:
            if self._wal is not None:
                # Fresh session over this dir: discard any surviving log
                # (e.g. a failed restore's rolled-back records) — appending
                # this session's boot AFTER them would make the next
                # failover replay the dead session's actors as ours.
                self._wal.reset()
            # First durable record: enough identity (tag/port/arena size) to
            # restore from a BARE log — a crash before the first checkpoint
            # must still recover everything appended so far.
            self._wal_append(
                "controller_boot",
                session_tag=store.SESSION_TAG,
                port=self.port,
                object_store_memory=self.object_store_memory,
            )
        # Head-store bulk plane (bulk.py): serves the controller's objects to
        # pulling agents the same way agents serve each other.
        from .bulk import BulkServer

        self._bulk_server = BulkServer(self.local_store, bind_host=bind)
        self._bulk_addr = f"{self.node_ip}:{self._bulk_server.start()}"
        # Warm-worker template (forkserver.py): pays the interpreter+import
        # cost once; CPU workers fork from it in ~10 ms once it is ready.
        from .forkserver import ForkServerClient

        self._forkserver = ForkServerClient(self.session_dir, "head")
        if rt_config.get("worker_forkserver"):
            self._forkserver.start()
        # Prometheus exposition (reference: `metrics_agent.py:83-95`).
        self._metrics_server = await asyncio.start_server(
            self._on_metrics_connection, host=bind, port=0
        )
        self.metrics_port = self._metrics_server.sockets[0].getsockname()[1]
        # Dashboard (reference: `dashboard/head.py`; here an in-process HTTP
        # server over the same state the state API serves).
        self.dashboard = None
        if rt_config.get("dashboard"):
            # Observability must never be fatal to the cluster: a taken port
            # (second cluster, stale process) degrades to no dashboard.
            try:
                from ..dashboard import DashboardServer

                self.dashboard = DashboardServer(self)
                await self.dashboard.start(rt_config.get("dashboard_port"))
            except OSError as e:
                print(f"dashboard disabled: {e}", file=sys.stderr)
                self.dashboard = None
        self._write_session_info()
        if self.standalone:
            store.mark_restorable(store.SESSION_TAG, True)
        if not restored:
            for _ in range(self._min_workers):
                self._spawn_worker()
        asyncio.ensure_future(self._gc_loop())
        asyncio.ensure_future(self._snapshot_loop())
        asyncio.ensure_future(self._health_check_loop())
        asyncio.ensure_future(self._head_memory_monitor_loop())

    # --------------------------------------------------- persistence (GCS FT)
    # Reference analog: GCS tables behind `RedisStoreClient`
    # (`redis_store_client.h:33`) + replay via `gcs_init_data.cc`. Redesign:
    # a WRITE-AHEAD EVENT LOG (event_log.py) appends every state-mutating
    # transition as it happens; the periodic pickle of the durable
    # directories is now a CHECKPOINT that compacts the log (snapshot =
    # checkpoint + truncate-before). A restarted controller restores the
    # checkpoint, REPLAYS the log past it, re-binds the SAME port, and
    # re-adopts workers as they reconnect (their shm arena survived the
    # crash — kill -9 skips teardown, and segment names key off the
    # ORIGINAL session tag). Recovery loses nothing after the last WAL
    # fsync instead of everything after the last snapshot tick. See
    # docs/CONTROL_PLANE_HA.md for the record schema and recovery ordering.
    def _open_wal(self):
        """The WAL is active exactly where restore is possible: standalone
        controllers (driver-owned sessions die with their driver) with a
        durable metadata backend."""
        if not self.standalone or not rt_config.get("wal_enabled"):
            return
        if str(rt_config.get("gcs_storage")).startswith("memory"):
            return
        from .event_log import EventLog

        self._wal = EventLog(
            os.path.join(self.session_dir, "wal"),
            segment_bytes=rt_config.get("wal_segment_bytes"),
            sync=rt_config.get("wal_sync"),
            fsync_interval_s=rt_config.get("wal_fsync_interval_s"),
            fsync_bytes=rt_config.get("wal_fsync_bytes"),
            on_fsync=self._on_wal_fsync,
        )
        if self._wal.truncated_records:
            # Torn tail cut at open: the dropped bytes were never
            # acknowledged durable, but leave a forensic marker.
            self._event(
                "recovery_truncated", records=self._wal.truncated_records
            )

    def _wal_append(self, kind: str, **fields):
        if self._wal is not None:
            self._wal.append(kind, fields)

    def _on_wal_fsync(self, seconds: float):
        # Fires on the WAL flusher THREAD — marshal onto the main loop (the
        # metric dicts are main-loop-owned, and /metrics iterates them).
        loop = getattr(self, "_main_loop", None)
        if loop is not None:
            try:
                loop.call_soon_threadsafe(
                    self._self_observe, "controller_log_fsync_seconds", seconds
                )
            except RuntimeError:
                pass  # loop closed (shutdown)

    # Controller-internal metric feeds: same aggregation shapes as
    # h_record_metric, but written locally (the controller has no client
    # backend to push through). Families/boundaries live in util/metrics.py
    # so tests and dashboards share one definition.
    def _self_inc(self, name: str, value: float):
        key = (name, ())
        from ..util.metrics import CONTROLLER_HA_HELP

        self.user_metric_help.setdefault(name, CONTROLLER_HA_HELP.get(name, ""))
        cur = self.user_metrics.get(key, (0.0, None, 0.0))[0]
        self.user_metrics[key] = (cur + value, "counter", time.time())

    def _self_set_gauge(self, name: str, value: float):
        from ..util.metrics import CONTROLLER_HA_HELP

        self.user_metric_help.setdefault(name, CONTROLLER_HA_HELP.get(name, ""))
        self.user_metrics[(name, ())] = (value, "gauge", time.time())

    def _self_observe(self, name: str, value: float):
        from ..util.metrics import CONTROLLER_HA_BOUNDARIES, CONTROLLER_HA_HELP

        boundaries = CONTROLLER_HA_BOUNDARIES[name]
        self.user_metric_help.setdefault(name, CONTROLLER_HA_HELP.get(name, ""))
        key = (name, ())
        h = self.user_hists.get(key)
        if h is None:
            h = self.user_hists[key] = {
                "boundaries": boundaries,
                "buckets": [0] * (len(boundaries) + 1),
                "sum": 0.0, "count": 0,
            }
        idx = 0
        while idx < len(boundaries) and value > boundaries[idx]:
            idx += 1
        h["buckets"][idx] += 1
        h["sum"] += float(value)
        h["count"] += 1
        h["ts"] = time.time()

    def _spec_blob(self, actor_hex: str, spec) -> Optional[bytes]:
        """Specs are immutable — pickle once, not on every snapshot tick."""
        if spec is None:
            return None
        blob = self._spec_blobs.get(actor_hex)
        if blob is None:
            blob = self._spec_blobs[actor_hex] = cloudpickle.dumps(spec)
        return blob

    def _snapshot_state(self) -> dict:
        from .control_shards import HASH_NAME

        return {
            "session_tag": store.SESSION_TAG,
            # WAL position this checkpoint covers: restore replays records
            # AFTER this seq; compaction unlinks segments at or below it.
            "wal_seq": self._wal.seq if self._wal is not None else 0,
            # Shard layout at snapshot time (forensics + the FT test's
            # cross-shard invariant: the per-shard id lists are disjoint and
            # their union is exactly the actor table). Restore re-routes by
            # the restoring controller's OWN layout, so this is a record,
            # not a constraint.
            "shard_layout": {
                "n": len(self.shards),
                "hash": HASH_NAME,
                "actor_shards": [sorted(sh.actors) for sh in self.shards],
                "worker_shards": [sorted(sh.workers) for sh in self.shards],
            },
            "port": self.port,
            "object_store_memory": self.object_store_memory,
            "store_bytes_used": self.store_bytes_used,
            "named_actors": dict(self.named_actors),
            "jobs": {
                jid: {k: j[k] for k in
                      ("pid", "entrypoint", "status", "log_path",
                       "start_time", "end_time")}
                for jid, j in self.jobs.items()
            },
            "actors": {
                h: {
                    "spec": self._spec_blob(h, a.spec),
                    "name": a.name,
                    "namespace": a.namespace,
                    "handle_bytes": a.handle_bytes,
                    "state": a.state,
                    "worker_id": a.worker_id,
                    "restarts_used": a.restarts_used,
                    "detached": a.detached,
                }
                for h, a in self.actors.items()
            },
            "pgs": {k: dict(v) for k, v in self.pgs.items()},
            "objects": {
                h: {
                    "status": o.status,
                    "inline": o.inline,
                    "locations": dict(o.locations),
                    "spilled_path": o.spilled_path,
                    "spilled_node": o.spilled_node,
                    "size": o.size,
                    "ever_held": o.ever_held,
                    "expected": o.expected,
                    "contains": list(o.contains),
                }
                for h, o in self.objects.items()
                if o.status == "ready"
            },
        }

    async def _snapshot_loop(self):
        # Driver-owned sessions (non-standalone) die with their driver and
        # can never restore — don't pay the checkpoint cost for them.
        if not self.standalone:
            return
        loop = asyncio.get_running_loop()

        def dump(state: dict):
            self._gcs_store.put(self._SNAPSHOT_KEY, cloudpickle.dumps(state))

        while not self._shutdown_event.is_set():
            await asyncio.sleep(rt_config.get("snapshot_interval_s"))
            try:
                # Build the (shallow-copied) state on-loop, serialize + write
                # OFF-loop — large tables must not stall scheduling/RPC.
                state = self._snapshot_state()
                await loop.run_in_executor(None, dump, state)
                # Checkpoint landed: compact the log (truncate-before). The
                # durability boundary is the WAL fsync, not this tick.
                if self._wal is not None:
                    self._wal.checkpoint(state["wal_seq"])
                    self._self_set_gauge(
                        "controller_log_bytes", float(self._wal.total_bytes())
                    )
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    def _restore_state(self) -> bool:
        """Checkpoint restore + WAL replay. Either alone is sufficient: a
        bare log (crash before the first checkpoint) replays from its
        controller_boot record; a bare checkpoint (WAL disabled) restores
        exactly the old snapshot semantics."""
        snap = None
        try:
            snap = cloudpickle.loads(self._gcs_store.get(self._SNAPSHOT_KEY))
        except Exception:  # noqa: BLE001 — missing/corrupt checkpoint: the
            # WAL replay below may still carry the full state; a corrupt
            # checkpoint with no WAL is a fresh start (marked in the
            # timeline once the controller is up).
            snap = None
        wal_seq = 0
        identity = False  # session_tag/port adopted from SOME durable source
        if snap is not None:
            wal_seq = int(snap.get("wal_seq", 0))
            store.set_session_tag(snap["session_tag"])
            self.port = snap["port"]
            self.object_store_memory = snap["object_store_memory"]
            self.store_bytes_used = snap.get("store_bytes_used", 0)
            identity = True
            self.named_actors = dict(snap["named_actors"])
            for jid, j in snap.get("jobs", {}).items():
                self.jobs[jid] = {**j, "proc": None}  # re-adopted by pid
            for h, a in snap["actors"].items():
                astate = ActorState(
                    actor_hex=h,
                    spec=cloudpickle.loads(a["spec"]) if a["spec"] else None,
                    name=a["name"],
                    namespace=a["namespace"],
                    handle_bytes=a["handle_bytes"],
                    detached=a["detached"],
                )
                astate.restarts_used = a["restarts_used"]
                astate.worker_id = a["worker_id"]
                # Until its worker reconnects, the actor is "restarting":
                # calls queue instead of failing (reference: restart states).
                astate.state = "restarting" if a["state"] in ("alive", "pending", "restarting") else a["state"]
                # Insertion re-routes by the CURRENT shard layout — a restore
                # with a different controller_shards repartitions cleanly.
                self.actors[h] = astate
                astate.shard = self.actors.shard_for(h)
            for k, v in snap["pgs"].items():
                self.pgs[k] = dict(v)
            for h, o in snap["objects"].items():
                obj = self._obj(h)
                obj.status = o["status"]
                obj.inline = o["inline"]
                obj.locations = dict(o["locations"])
                obj.spilled_path = o["spilled_path"]
                obj.spilled_node = o["spilled_node"]
                obj.size = o["size"]
                obj.ever_held = o["ever_held"]
                obj.expected = o["expected"]
                obj.contains = list(o["contains"])
                for c in obj.contains:
                    self._obj(c).pinned += 1
        replayed = 0
        if self._wal is not None:
            for seq, kind, fields in self._wal.replay(from_seq=wal_seq):
                if self._apply_wal_record(kind, fields):
                    identity = True
                replayed += 1
        if not identity:
            # Neither checkpoint nor boot record survived (corrupt blob AND
            # the boot record compacted away). This boots as a FRESH session
            # — roll back anything replay already inserted, or ghost actors
            # stuck 'restarting' (no readopt timer arms) would squat names
            # and poison list_actors forever.
            self.actors.clear()
            self.named_actors.clear()
            self.pgs.clear()
            self.objects.clear()
            self.jobs.clear()
            self.store_bytes_used = 0
            return False
        self.local_store = store.make_store(create_arena=False)  # re-attach
        # Actors whose creation never reached a worker (registered/queued at
        # crash time — worker_id empty) restart their creation task NOW
        # instead of waiting out the 40s re-adoption deadline (which would
        # also burn restart budget for a worker that never existed).
        requeued = 0
        for astate in self.actors.values():
            if (
                astate.state == "restarting"
                and not astate.worker_id
                and astate.spec is not None
            ):
                astate.state = "pending"
                self._pin_args(astate.spec)
                self._enqueue(PendingTask(spec=astate.spec, retries_left=0))
                requeued += 1
        if requeued:
            self._schedule()
        # Re-apply PG reservations against head capacity exactly once, over
        # the MERGED (checkpoint + replay) table — bundles were reserved
        # pre-crash; remote nodes re-register with fresh availability, so
        # only the head's books need the deduction.
        for pg in self.pgs.values():
            for b, nid in zip(pg["bundles"], pg.get("bundle_nodes") or []):
                if nid == HEAD_NODE:
                    self._acquire(self.head, b)
        self._event("controller_restored", actors=len(self.actors),
                    objects=len(self.objects), replayed=replayed)
        asyncio.get_running_loop().call_later(
            rt_config.get("readopt_deadline_s"),
            lambda: asyncio.ensure_future(self._readopt_deadline()),
        )
        return True

    # Kept under its historical name for callers/tests that restore
    # explicitly.
    _load_snapshot = _restore_state

    def _apply_wal_record(self, kind: str, fields: dict) -> bool:
        """Apply one replayed WAL record to the directories. IDEMPOTENT by
        construction — replaying the same log twice reaches a fixpoint (the
        replay-idempotency test's invariant): creations skip existing
        entries, deaths re-set terminal states, connection-scoped records
        (workers, leases) are no-ops because that state cannot outlive the
        peer's TCP connection. Returns True for identity-bearing records
        (controller_boot)."""
        if kind == "controller_boot":
            # Fallback identity when no checkpoint landed before the crash.
            if not store.SESSION_TAG:
                store.set_session_tag(fields["session_tag"])
                self.port = fields["port"]
                self.object_store_memory = fields["object_store_memory"]
            return True
        if kind == "actor_registered":
            h = fields["actor"]
            if h in self.actors:
                return False
            astate = ActorState(
                actor_hex=h,
                spec=spec_from_proto_bytes(fields["spec"]),
                name=fields.get("name", ""),
                namespace=fields.get("namespace", "default"),
                handle_bytes=fields.get("handle", b""),
                detached=bool(fields.get("detached")),
            )
            astate.state = "restarting"
            self.actors[h] = astate
            astate.shard = self.actors.shard_for(h)
            if astate.name:
                self.named_actors.setdefault(
                    (astate.namespace, astate.name), h
                )
            return False
        astate = self.actors.get(fields.get("actor", ""))
        if kind == "actor_infeasible":
            if astate is None:
                a = ActorState(
                    actor_hex=fields["actor"], spec=None, state="dead"
                )
                a.init_error = TaskError(
                    RuntimeError(fields.get("error", "infeasible")), "",
                    "actor creation",
                )
                self.actors[fields["actor"]] = a
                a.shard = self.actors.shard_for(fields["actor"])
            return False
        if kind == "actor_alive":
            if astate is not None and astate.state != "dead":
                astate.worker_id = fields.get("worker") or astate.worker_id
                # Stays "restarting": alive again only when its worker
                # actually reconnects (h_register_worker re-adoption).
            return False
        if kind == "actor_restarting":
            if astate is not None and astate.state != "dead":
                astate.restarts_used = max(
                    astate.restarts_used, int(fields.get("restarts_used", 0))
                )
                astate.state = "restarting"
            return False
        if kind in ("actor_death", "actor_killed"):
            if astate is not None:
                astate.state = "dead"
                if fields.get("no_restart", True):
                    astate.spec = None
                for key, ah in list(self.named_actors.items()):
                    if ah == fields["actor"]:
                        del self.named_actors[key]
            return False
        if kind == "pg_created":
            self.pgs.setdefault(fields["pg"], {
                "bundles": fields["bundles"],
                "strategy": fields["strategy"],
                "name": fields.get("name", ""),
                "ready": bool(fields.get("ready")),
                "bundle_nodes": fields.get("bundle_nodes") or [],
                "bundle_avail": [dict(b) for b in fields["bundles"]],
            })
            return False
        if kind == "pg_placed":
            pg = self.pgs.get(fields["pg"])
            if pg is not None and not pg["ready"]:
                pg["bundle_nodes"] = fields.get("bundle_nodes") or []
                pg["bundle_avail"] = [dict(b) for b in pg["bundles"]]
                pg["ready"] = True
            return False
        if kind == "pg_removed":
            self.pgs.pop(fields["pg"], None)
            return False
        if kind == "object_ready":
            obj = self._obj(fields["id"])
            if obj.status != "ready":  # checkpoint overlap / second replay
                obj.status = "ready"
                obj.inline = fields.get("inline")
                obj.size = int(fields.get("size", 0))
                obj.expected = True
                if fields.get("contains") and not obj.contains:
                    obj.contains = list(fields["contains"])
                    for ch in obj.contains:
                        self._obj(ch).pinned += 1
            if fields.get("name"):
                node = fields.get("node", HEAD_NODE)
                if node not in obj.locations:
                    obj.locations[node] = fields["name"]
                    if node == HEAD_NODE:
                        # Mirror the live accounting (_mark_ready): a head
                        # shm copy counts against the arena budget.
                        self.store_bytes_used += int(fields.get("size", 0))
            return False
        if kind == "object_freed":
            obj = self.objects.pop(fields["id"], None)
            if obj is not None:
                if HEAD_NODE in obj.locations:
                    self.store_bytes_used -= obj.size
                for ch in obj.contains:
                    inner = self.objects.get(ch)
                    if inner is not None:
                        inner.pinned = max(0, inner.pinned - 1)
            return False
        # worker_registered / lease_granted / lease_returned /
        # named-actor forensics: connection-scoped — the state cannot
        # outlive the peer's conn, which did not survive the crash. Workers
        # re-register live; lease holders re-request. Recorded for
        # forensics and the chaos suite's ordering assertions only.
        return False

    async def _readopt_deadline(self):
        """Actors still 'restarting' after the reconnect window lost their
        worker during the outage — run the normal death path so they restart
        from spec (or die) instead of queueing calls forever."""
        for actor_hex, astate in list(self.actors.items()):
            if astate.state != "restarting":
                continue
            ws = self.workers.get(astate.worker_id)
            if ws is not None and ws.state == ACTOR and ws.actor_hex == actor_hex:
                continue  # reconnected fine
            self._event("actor_readopt_timeout", actor=actor_hex)
            await self._on_actor_worker_death(actor_hex)

    def _write_session_info(self):
        """address.json + <SESSION_ROOT>/session_latest symlink — CLI discovery
        (reference analog: ray's session_latest convention; the reference's
        root is fixed, ray_tpu/core/controller.py:1054)."""
        import json

        info = {
            "address": f"{self.node_ip}:{self.port}",
            "metrics_url": f"http://{self.node_ip}:{self.metrics_port}/metrics",
            "session_dir": self.session_dir,
            "pid": os.getpid(),
            # Local CLI/driver discovery; remote joiners get the token
            # out-of-band (documented in README multi-host bring-up).
            "auth_token": rpc_auth_token(),
        }
        if getattr(self, "dashboard", None) is not None:
            info["dashboard_url"] = f"http://{self.node_ip}:{self.dashboard.port}"
        # 0600: the file carries the auth token — other local users must not
        # read their way past the handshake on a multi-user machine.
        path = os.path.join(self.session_dir, "address.json")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(info, f)
        from .host_names import SESSION_ROOT  # (reference: "/tmp/ray_tpu", ray_tpu/core/controller.py:1075-1077)

        link = os.path.join(SESSION_ROOT, "session_latest")
        try:
            os.makedirs(SESSION_ROOT, exist_ok=True)
            tmp = f"{link}.{os.getpid()}"
            os.symlink(self.session_dir, tmp)
            os.replace(tmp, link)
        except OSError:
            pass

    async def serve_forever(self):
        await self._shutdown_event.wait()
        await self._teardown()

    async def _teardown(self):
        for j in self.jobs.values():  # supervised jobs die with the session
            proc = j.get("proc")
            try:
                if proc is not None and proc.poll() is None:
                    proc.terminate()
                elif proc is None and j.get("pid"):
                    os.kill(j["pid"], 15)
            except OSError:
                pass
        for node in self.nodes.values():
            if node.conn is not None and node.alive:
                try:
                    await node.conn.send({"type": "exit"})
                except Exception:  # noqa: BLE001
                    pass
        for ws in self.workers.values():
            if ws.conn is not None:
                try:
                    await ws.conn.send({"type": "exit"})
                except Exception:  # noqa: BLE001
                    pass
        await asyncio.sleep(0.05)
        # list(): the fork-flusher thread may still be registering
        # PidHandles mid-burst; a live dict would raise mid-iteration.
        for proc in list(self._worker_procs.values()):
            if proc.poll() is None:
                proc.terminate()
        for obj in self.objects.values():
            if obj.shm_name:
                self.local_store.release(obj.shm_name, unlink=True)
        self.local_store.close_all(unlink=False)
        arena = getattr(self.local_store, "arena", None)
        if arena is not None:
            arena.unlink()  # whole-session segment; workers are exiting
        if self.standalone:  # graceful end — session no longer restorable
            store.mark_restorable(store.SESSION_TAG, False)
        if self._server:
            self._server.close()
        if self._wal is not None:
            self._wal.close()
        if getattr(self, "_bulk_server", None) is not None:
            self._bulk_server.stop()
        if getattr(self, "_forkserver", None) is not None:
            self._forkserver.stop()
        for sh in self.shards:
            sh.stop()

    # ------------------------------------------------------------- workers
    def _spawn_worker(
        self,
        tpu: bool = False,
        node: Optional[NodeState] = None,
        live_count: Optional[int] = None,
        force: bool = False,
        isolation: Optional[dict] = None,
    ):
        """Spawn a worker on `node` (default head). Remote nodes spawn via
        their agent (reference: raylet `WorkerPool::StartWorkerProcess`).
        `live_count` (alive workers on the node) skips the O(workers) scan
        when the caller already counted (the scheduler's per-pass cache).
        `force` bypasses the task-pool cap — ACTORS own dedicated processes
        (reference semantics: tens of thousands of actor workers), so the
        cap that bounds task-worker prestarting must not deadlock actor
        creation."""
        node = node or self.head
        # Boot-rate limit (ALL spawn kinds, incl. forced actor spawns): each
        # booting interpreter costs ~2s of CPU; an unbounded burst (observed:
        # 500+ booting during a 2000-actor envelope probe) thrashes the
        # machine until registrations time out. Deferral is safe — every
        # registration fires _schedule, which re-flushes pending spawn
        # demand until it drains.
        # The spawn ledger IS the in-flight boot set (one entry per spawn,
        # removed at registration/expiry) — counting it is O(1)-ish where
        # the old per-call worker-table scan was O(workers) and went
        # quadratic across a 2,000-spawn wave.
        booting = len(self._spawn_ledger)
        boot_cap = rt_config.get("worker_boot_concurrency")
        if self._forkserver is not None and self._forkserver.usable:
            # Forked workers skip the ~2s interpreter boot the cap was sized
            # for; registration (the remaining cost) tolerates a deeper queue.
            boot_cap *= 4
        if booting >= boot_cap:
            return
        if tpu:
            if node.spawning_tpu > 0:
                return
            node.spawning_tpu += 1
        else:
            if live_count is None:
                # Task-POOL occupancy only: dedicated ACTOR workers are
                # excluded, else long-lived actors eat the cap and starve
                # plain tasks of workers forever.
                live_count = sum(
                    1 for w in self.workers.values()
                    if w.state not in (DEAD, ACTOR) and w.node_id == node.node_id
                    and not w.env_key  # isolated workers are outside the pool
                )
            if not force and node.spawning + live_count >= self._max_workers:
                return
        node.spawning += 1
        self._spawn_ledger.append((node.node_id, time.monotonic(), tpu))
        worker_id = f"w{next(self._worker_counter)}"
        self._event("worker_spawn", worker=worker_id, forced=force)
        if isolation is not None:
            # Registration looks the env_key up by worker_id (the worker
            # itself doesn't need to know its isolation hash).
            self._worker_env_keys[worker_id] = isolation["key"]
            self._iso_booting[(node.node_id, isolation["key"])] = (
                time.monotonic(), worker_id,
            )
        if node.conn is not None:
            try:
                node.conn.post({
                    "type": "spawn_worker", "worker_id": worker_id,
                    "tpu": tpu, "isolation": isolation,
                })
            except ConnectionError:
                pass  # node dying — ledger expiry reclaims the boot budget
            return
        # Spawn-env template, built once: dict(os.environ) iterates the
        # environ Mapping in Python (a decode per key per spawn — measured
        # ~2.5s per 1,000-spawn wave); a plain dict copy is C-speed.
        base = getattr(self, "_spawn_env_base", None)
        if base is None:
            base = dict(os.environ)
            pkg_root0 = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            base["PYTHONPATH"] = pkg_root0 + os.pathsep + base.get("PYTHONPATH", "")
            base["RAY_TPU_ADDRESS"] = f"{self.node_ip}:{self.port}"
            base["RAY_TPU_NODE_IP"] = self.node_ip  # workers bind/advertise here
            base["RAY_TPU_SESSION_DIR"] = self.session_dir
            base["RAY_TPU_SESSION_TAG"] = store.SESSION_TAG
            base["PYTHONUNBUFFERED"] = "1"  # log tailing needs unbuffered stdout
            self._spawn_env_base = base
        env = dict(base)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["RAY_TPU_WORKER_ID"] = worker_id
        # GPU worker: sees the node's cards; CPU worker: sees none, so only
        # workers granted a GPU resource may attach the card.
        # (reference: TPU plugin env, ray_tpu/core/controller.py:1225-1236)
        env["RAY_TPU_WORKER_TPU"] = "1" if tpu else "0"
        pin_worker_devices(env, tpu, node.total.get(ACCELERATOR, 0))
        log_path = os.path.join(self.session_dir, f"worker-{worker_id}.log")
        argv = [sys.executable, "-m", "ray_tpu_torch.core.worker_main"]
        if isolation is not None:
            # conda/container wrap — never forkserver-able (the whole point
            # is a different interpreter/filesystem).
            from ..runtime_env.isolation import build_argv

            env["RAY_TPU_ENV_KEY"] = isolation["key"]
            try:
                argv = build_argv(isolation, argv, env, self.session_dir)
            except Exception as e:  # noqa: BLE001 — binary missing on node
                self._iso_spawn_failed(node, worker_id, isolation, repr(e), tpu=tpu)
                self._schedule()
                return
        if (
            # GPU workers fork too: the template imported torch without
            # touching CUDA, and the child is given its cards in its env
            # before its first CUDA call (`import torch` alone took ~10 s a
            # cold interpreter on the H100 host). (reference: `not tpu and
            # isolation is None`, TPU workers cold, ray_tpu/core/controller.py:1252)
            isolation is None
            and self._forkserver is not None and self._forkserver.usable
        ):
            # Warm path: ~10 ms fork from the pre-imported template. Fork
            # preserves the no-pdeathsig property (the template, not the
            # controller, is the parent — and it ignores SIGCHLD). Async +
            # batched: the round trip must not block the event loop, and a
            # creation burst coalesces into few template trips. Failed
            # trips recover via spawn-ledger expiry (see spawn_async).
            self._forkserver.spawn_async(
                worker_id, env, log_path, self._worker_procs.__setitem__
            )
            return
        self._worker_procs[worker_id] = self._popen_cold(
            argv, env, log_path, pkg_root
        )

    @staticmethod
    def _popen_cold(argv, env, log_path, cwd) -> subprocess.Popen:
        log_f = open(log_path, "ab")
        return subprocess.Popen(
            argv,
            env=env,
            stdout=log_f,
            stderr=subprocess.STDOUT,
            cwd=cwd,
            # NO pdeathsig here: head workers deliberately survive a
            # controller crash so a restarted controller re-adopts them
            # (controller FT). Orphan cleanup is the worker's reconnect
            # grace timeout, not process lineage.
        )

    def _spawn_isolated(self, node: "NodeState", spec, tpu: bool = False):
        """Spawn a worker wrapped in the task's conda/container isolation
        (reference: raylet starting runtime-env workers through the agent's
        env setup, `worker_pool.cc` PopWorker w/ runtime_env_hash). One boot
        per (node, key) at a time, with a grace window so a dead spawn
        doesn't wedge the key forever."""
        from ..runtime_env.isolation import resolve

        isolation = resolve(spec.options.runtime_env)
        if isolation is None:
            return
        key = isolation["key"]
        if (node.node_id, key) in self._iso_unavailable:
            # The binary is missing on THIS node; another may serve the env.
            alt = self._iso_candidate(spec, key)
            if alt is None:
                self._fail_iso_tasks_without_candidates(key)
                return
            node = alt
        booting = self._iso_booting.get((node.node_id, key))
        if booting is not None:
            last, prev_worker = booting
            attempts_so_far = self._iso_attempts.get((node.node_id, key), 0)
            # Grace grows with attempts: slow env setups (image pull, heavy
            # conda activate) on REMOTE nodes are unobservable from here —
            # the widening window keeps them from being misread as dead.
            grace = rt_config.get("iso_boot_grace_s") * (attempts_so_far + 1)
            if time.monotonic() - last < grace:
                return  # a worker for this env is already booting there
            proc = self._worker_procs.get(prev_worker)
            alive = (
                proc is not None and hasattr(proc, "poll") and proc.poll() is None
            ) or (
                # Agent-spawned: no proc handle here, but the agent reports
                # spawn liveness in health-probe replies — a slow remote env
                # setup (5-min image pull) must extend the window like local
                # slow boots do, not burn the attempt budget (ADVICE r4).
                proc is None and prev_worker in node.agent_alive_workers
            )
            if alive:
                # Still ALIVE past the grace — a slow boot, not a dead one.
                # Extend the window rather than double-spawning or counting
                # a failure.
                self._iso_booting[(node.node_id, key)] = (
                    time.monotonic(), prev_worker,
                )
                return
            # Dead (or agent-spawned and unobservable) without registering:
            # bad conda env name, unpullable image, ... Count it exactly
            # once — the entry is POPPED here and only re-armed by
            # _spawn_worker when a new spawn actually launches, so a
            # boot-cap deferral can never inflate the counter. After a few
            # dead attempts the node stops being a candidate, which
            # surfaces RuntimeEnvSetupError to the queued tasks — the
            # reference's RUNTIME_ENV_SETUP_FAILED contract
            # (`python/ray/_private/runtime_env/container.py`).
            # NOTE: _worker_env_keys[prev_worker] is kept for unobservable
            # spawns — if the spawn is merely slow (remote) and registers
            # later, its env key must still resolve or an ISOLATED worker
            # would join the plain pool and run non-isolated tasks in the
            # wrong world. Registration pops it; a truly dead attempt leaks
            # one short string, bounded at 3 per (node, env).
            self._iso_booting.pop((node.node_id, key), None)
            if proc is not None:
                self._worker_procs.pop(prev_worker, None)
                self._worker_env_keys.pop(prev_worker, None)
            attempts = attempts_so_far + 1
            self._iso_attempts[(node.node_id, key)] = attempts
            if attempts >= 3:
                self._iso_unavailable[(node.node_id, key)] = (
                    f"isolated worker died before registering "
                    f"{attempts} times (broken env?)"
                )
                self._fail_iso_tasks_without_candidates(key)
                return
        self._spawn_worker(tpu=tpu, node=node, force=True, isolation=isolation)

    def _iso_candidate(self, spec, key: str) -> Optional["NodeState"]:
        """An alive node not yet marked binary-less for this env whose
        TOTAL resources could host the task."""
        for node in self.nodes.values():
            if (
                node.alive
                and (node.node_id, key) not in self._iso_unavailable
                and all(
                    node.total.get(k, 0) >= v
                    for k, v in spec.resources.items()
                )
            ):
                return node
        return None

    def _fail_iso_tasks_without_candidates(self, key: str):
        """Fail queued tasks for this env ONLY once no alive node can host
        it (reference: RUNTIME_ENV_SETUP_FAILED) — a missing binary is a
        per-node property, not a cluster verdict."""
        from ..runtime_env import RuntimeEnvSetupError

        doomed = [
            pt for pt in self.ready_queue
            if _task_env_key(pt.spec) == key
            and self._iso_candidate(pt.spec, key) is None
        ]
        if not doomed:
            return
        why = "; ".join(sorted({
            v for (n, k), v in self._iso_unavailable.items() if k == key
        }))
        for pt in doomed:
            self.ready_queue.remove(pt)
            self._fail_task(
                pt,
                TaskError(
                    RuntimeEnvSetupError(
                        f"no node can host this environment: {why}"
                    ),
                    "", pt.spec.name,
                ),
            )

    def _iso_spawn_failed(self, node, worker_id: str, isolation: dict,
                          why: str, tpu: bool = False):
        """Isolated spawn couldn't even exec (missing conda/podman on this
        node): give back the FULL spawn bookkeeping (counter + ledger, like
        registration does), mark the node unavailable for the env, and fail
        only tasks no other node can serve."""
        node.spawning = max(0, node.spawning - 1)
        if tpu:
            node.spawning_tpu = max(0, node.spawning_tpu - 1)
        for i, entry in enumerate(self._spawn_ledger):
            if entry[0] == node.node_id and entry[2] == tpu:
                del self._spawn_ledger[i]
                break
        self._worker_env_keys.pop(worker_id, None)
        key = isolation["key"]
        self._iso_booting.pop((node.node_id, key), None)
        self._iso_unavailable[(node.node_id, key)] = why
        self._fail_iso_tasks_without_candidates(key)

    # ---------------------------------------------------------- connection
    async def _on_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn = Connection(reader, writer, expected_token=rpc_auth_token())
        meta = {"kind": None, "worker_id": None, "conn_id": next(self._conn_counter)}
        self._conns_by_id[meta["conn_id"]] = conn

        async def on_push(msg: dict):
            try:
                await self._dispatch_msg(conn, meta, msg)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

        async def on_close():
            await self._on_disconnect(conn, meta)

        conn.on_push = on_push
        conn.on_close = on_close
        conn.start()

    # Handlers that may await object readiness. They only READ shared state, so
    # they run as detached tasks — otherwise a long-poll would block the
    # connection's read loop and deadlock clients that get() on one thread
    # while another thread produces the object.
    _LONG_POLL = frozenset({"get_object", "get_objects", "wait_objects",
                            "tail_logs", "stream_next", "request_lease"})

    async def _dispatch_msg(self, conn: Connection, meta: dict, msg: dict):
        mtype = msg["type"]
        handler = getattr(self, f"h_{mtype}", None)
        if handler is None:
            if msg.get("req_id") is not None:
                await conn.respond(msg["req_id"], {"error": f"unknown message {mtype}"})
            return

        async def run():
            result = await handler(conn, meta, msg)
            if msg.get("req_id") is not None:
                conn.respond_nowait(msg["req_id"], result)

        if mtype in self._LONG_POLL:
            asyncio.ensure_future(run())
        else:
            await run()

    async def _on_disconnect(self, conn: Connection, meta: dict):
        # A dead process's refs die with it (reference: borrower death
        # detection via pubsub channel close).
        conn_id = meta.get("conn_id")
        if conn_id is not None:
            self._conns_by_id.pop(conn_id, None)
        # Leases die with their holder.
        for worker_id in meta.get("leases") or ():
            ws = self.workers.get(worker_id)
            if ws is not None and ws.leased_to == conn_id:
                self._release_lease(ws, requeue=False)
        if meta.get("leases"):
            self._schedule()
        if conn_id is not None:
            for hex_id in self._conn_refs.pop(conn_id, ()):
                obj = self.objects.get(hex_id)
                if obj is not None:
                    obj.holders.discard(conn_id)
                    self._maybe_gc(hex_id)
        if meta["kind"] == "worker":
            # Only the CURRENT registration's conn declares the worker dead:
            # a reconnecting worker can race itself during a head failover
            # (two register frames, second replaces the first), and the
            # stale conn's close must not kill the live re-registration —
            # observed killing a just-re-adopted actor host, which then
            # burned the actor's restart budget for a worker still alive.
            cur_ws = self.workers.get(meta["worker_id"])
            if cur_ws is None or cur_ws.conn is conn:
                await self._on_worker_death(meta["worker_id"])
        elif meta["kind"] == "node":
            # Only the CURRENT registration's conn declares the node dead: a
            # re-announced agent (failover reconnect) may have replaced this
            # conn already — its stale close must not kill the fresh record.
            cur = self.nodes.get(meta["node_id"])
            if cur is None or cur.conn is conn:
                await self._on_node_death(meta["node_id"])
        elif meta["kind"] == "driver":
            self.drivers.discard(conn)
            if not self.drivers and not self.standalone:
                # Last driver gone → end the session.
                self._shutdown_event.set()

    # ----------------------------------------------------------- handlers
    async def h_register_driver(self, conn, meta, msg):
        meta["kind"] = "driver"
        # A worker's nested-API backend registers as a driver too — adopt
        # its node so gets materialize objects in ITS node's arena (pulling
        # into the head instead was a triple copy on one machine and a
        # correctness hole across machines: the worker would try to open a
        # /dev/shm name that only exists on the head).
        meta["node_id"] = msg.get("node_id", HEAD_NODE)
        self.drivers.add(conn)
        return {
            "ok": True,
            "session_dir": self.session_dir,
            "session_tag": store.SESSION_TAG,
            # Controller wall clock for the registrant's RTT-midpoint
            # flight-recorder clock alignment (see cluster_backend._connect).
            "time": time.time(),
        }

    async def h_register_client(self, conn, meta, msg):
        # Secondary connection from a worker's nested-API backend (or an
        # agent's fetch client). Carries its node so gets resolve locally.
        meta["kind"] = "client"
        meta["node_id"] = msg.get("node_id", HEAD_NODE)
        return {"ok": True, "time": time.time()}

    async def h_register_worker(self, conn, meta, msg):
        worker_id = msg["worker_id"]
        node_id = msg.get("node_id", HEAD_NODE)
        meta["kind"] = "worker"
        meta["worker_id"] = worker_id
        # Duplicate registration (a reconnecting worker racing itself across
        # a head failover — two register frames, second replaces the first):
        # release the replaced record's capacity grant BEFORE the re-adoption
        # block below re-acquires, or the node's books double-deduct the
        # actor's resources on every extra frame.
        old_ws = self.workers.get(worker_id)
        if old_ws is not None and old_ws.assigned:
            if old_ws.blocked:
                old_ws.assigned = {}
                old_ws.assigned_pg = None
            else:
                self._grant_release(old_ws)
        # Prefer the worker's self-report (survives controller restarts —
        # the in-memory map doesn't); fall back to the spawn-time record.
        env_key = msg.get("env_key") or self._worker_env_keys.pop(worker_id, "")
        self._worker_env_keys.pop(worker_id, None)
        if env_key:
            self._iso_booting.pop((node_id, env_key), None)
            self._iso_attempts.pop((node_id, env_key), None)
            # A registered worker PROVES the env works here — undo any
            # unavailable verdict a slow earlier boot may have left.
            self._iso_unavailable.pop((node_id, env_key), None)
        ws = WorkerState(
            worker_id=worker_id,
            conn=conn,
            pid=msg.get("pid", 0),
            state=IDLE,
            has_tpu=bool(msg.get("has_tpu")),
            node_id=node_id,
            direct_addr=msg.get("direct_addr", ""),
            env_key=env_key,
        )
        self.workers[worker_id] = ws
        # Re-adoption after a controller restart: a surviving actor worker
        # reconnects carrying its actor id — restore the binding and wake
        # the actor's queued calls (reference analog: GCS restart replaying
        # actor tables + workers re-registering).
        actor_hex = msg.get("actor_hex")
        if actor_hex:
            astate = self.actors.get(actor_hex)
            if astate is not None and astate.state != "dead":
                ws.state = ACTOR
                ws.actor_hex = actor_hex
                astate.worker_id = worker_id
                # Re-acquire the actor's capacity grant or the books show
                # its resources free (double-booking). PG-backed actors skip
                # the deduction: the snapshotted bundle_avail already
                # reflects their consumption.
                if astate.spec is not None:
                    demand = astate.spec.resources
                    strat = astate.spec.options.scheduling_strategy
                    if (
                        isinstance(strat, PlacementGroupSchedulingStrategy)
                        and strat.placement_group is not None
                    ):
                        pg_hex = strat.placement_group.id.hex()
                        bidx = max(strat.placement_group_bundle_index, 0)
                        ws.assigned = dict(demand)
                        ws.assigned_pg = (pg_hex, bidx)
                    else:
                        node0 = self.nodes.get(node_id)
                        if node0 is not None:
                            self._acquire(node0, demand)
                        ws.assigned = dict(demand)
                self._set_actor_state(astate, "alive")
                self._event("actor_readopted", actor=actor_hex, worker=worker_id)
        node = self.nodes.get(node_id)
        if node is not None:
            node.spawning = max(0, node.spawning - 1)
            if ws.has_tpu:
                node.spawning_tpu = max(0, node.spawning_tpu - 1)
            for i, entry in enumerate(self._spawn_ledger):
                if entry[0] == node_id and entry[2] == ws.has_tpu:
                    del self._spawn_ledger[i]
                    break
        self._worker_arrival.set()
        self._worker_arrival.clear()
        # Connection-scoped (a worker entry cannot outlive its conn, so
        # replay is a no-op) — recorded for forensics/ordering only.
        self._wal_append("worker_registered", worker=worker_id,
                         node=node_id, actor=actor_hex or "")
        self._event("worker_registered", worker=worker_id)
        self._schedule()
        return {"ok": True, "time": time.time()}

    async def h_register_node(self, conn, meta, msg):
        """A node agent joined (reference: `GcsNodeManager::HandleRegisterNode`).
        The docstring seam promised in round 1 (`register_node`) — now real."""
        node_id = msg["node_id"]
        existing = self.nodes.get(node_id)
        if (
            existing is not None
            and existing.alive
            and existing.conn is not None
            and not existing.conn._closed
        ):
            return {"ok": False, "error": f"node id {node_id} already registered"}
        if existing is not None:
            # Re-announce after a head failover (or an agent-side reconnect
            # whose old conn the head hasn't reaped yet): replace the stale
            # record — the fresh registration carries current capacity, and
            # the node's workers re-register themselves.
            self.nodes.pop(node_id, None)
        meta["kind"] = "node"
        meta["node_id"] = node_id
        total = {k: float(v) for k, v in (msg.get("resources") or {}).items()}
        self.nodes[node_id] = NodeState(
            node_id=node_id,
            conn=conn,
            fetch_addr=msg.get("fetch_addr", ""),
            bulk_addr=msg.get("bulk_addr", ""),
            dispatch=bool(msg.get("local_dispatch")),
            total=dict(total),
            available=dict(total),
            session_tag=msg.get("session_tag", ""),
            object_store_memory=msg.get("object_store_memory", 0),
            labels={k: str(v) for k, v in (msg.get("labels") or {}).items()},
        )
        self._event("node_added", node=node_id, resources=total)
        self._schedule()  # also retries pending PGs against the new capacity
        return {"ok": True, "time": time.time()}

    def _retry_pending_pgs(self):
        """Re-attempt placement of PGs that are not ready — new capacity (an
        autoscaled/added node, or resources freed by finished tasks) may
        satisfy them (reference:
        `GcsPlacementGroupManager::SchedulePendingPlacementGroups`).

        Partially-placed PGs (a node died, re-placement was infeasible) keep
        their surviving bundles' reservations: only the `None` slots are
        re-placed, seeded with the surviving nodes so STRICT_SPREAD keeps its
        distinctness invariant."""
        for pg_hex, pg in self.pgs.items():
            if pg["ready"]:
                continue
            if pg["bundle_nodes"] and any(n is not None for n in pg["bundle_nodes"]):
                missing = [i for i, n in enumerate(pg["bundle_nodes"]) if n is None]
                surviving = {n for n in pg["bundle_nodes"] if n is not None}
                placement = self._place_bundles(
                    [pg["bundles"][i] for i in missing],
                    pg["strategy"],
                    occupied=surviving,
                )
                if placement is None:
                    continue
                for i, nid in zip(missing, placement):
                    self._acquire(self.nodes[nid], pg["bundles"][i])
                    pg["bundle_nodes"][i] = nid
                    pg["bundle_avail"][i] = dict(pg["bundles"][i])
            else:
                placement = self._place_bundles(pg["bundles"], pg["strategy"])
                if placement is None:
                    continue
                for b, nid in zip(pg["bundles"], placement):
                    self._acquire(self.nodes[nid], b)
                pg["bundle_nodes"] = placement
                pg["bundle_avail"] = [dict(b) for b in pg["bundles"]]
            pg["ready"] = True
            self._wal_append("pg_placed", pg=pg_hex,
                             bundle_nodes=pg["bundle_nodes"])
            self._event("pg_placed", pg=pg_hex)

    async def h_shutdown(self, conn, meta, msg):
        self._shutdown_event.set()
        return {"ok": True}

    # ------------------------------------------------------------- objects
    def _obj(self, hex_id: str) -> ObjectState:
        obj = self.objects.get(hex_id)
        if obj is None:
            obj = self.objects[hex_id] = ObjectState()
        return obj

    def _mark_ready(
        self,
        hex_id: str,
        inline: Optional[bytes] = None,
        shm_name: Optional[str] = None,
        size: int = 0,
        node_id: str = HEAD_NODE,
        contains: Optional[List[str]] = None,
    ):
        obj = self._obj(hex_id)
        obj.status = "ready"
        obj.inline = inline
        if contains and not obj.contains:  # first registration only (a
            # reconstruction re-run re-reports the same nested ids)
            obj.contains = list(contains)
            for h in obj.contains:
                self._obj(h).pinned += 1
        if shm_name:
            obj.locations[node_id] = shm_name
        obj.size = size
        # WAL: the directory entry must survive a head crash in the window
        # before the next checkpoint — shm payloads outlive the head in the
        # arena (kill -9 skips teardown) and inline payloads ride the record
        # itself, so a put acknowledged to the client stays gettable across
        # failover. Freed ids are tombstoned below (_free_object).
        self._wal_append(
            "object_ready", id=hex_id, inline=inline, name=shm_name or "",
            size=size, node=node_id, contains=list(contains or ()),
        )
        obj.last_access = time.monotonic()
        if shm_name and node_id == HEAD_NODE:
            self.store_bytes_used += size
        for ev in obj.events:
            ev.set()
        obj.events.clear()
        # Unblock tasks waiting on this object.
        for task_hex in list(obj.dependents):
            pt = self.waiting_tasks.get(task_hex)
            if pt is not None:
                pt.deps_remaining.discard(hex_id)
                if not pt.deps_remaining:
                    del self.waiting_tasks[task_hex]
                    self.ready_queue.append(pt)
        obj.dependents.clear()
        self._maybe_spill()
        self._maybe_gc(hex_id)  # refs may have been dropped while pending
        self._schedule()

    def _store_error_object(self, hex_id: str, err: TaskError):
        frame = serialization.pack(err)
        self._mark_ready(hex_id, inline=frame)

    def _location_payload(self, obj: ObjectState, node_id: str = HEAD_NODE) -> dict:
        obj.last_access = time.monotonic()
        if obj.inline is not None:
            return {"status": "inline", "data": obj.inline}
        name = obj.locations.get(node_id)
        if name is not None:
            return {"status": "shm", "name": name, "size": obj.size}
        if obj.spilled_path is not None and obj.spilled_node == node_id:
            return {"status": "spilled", "path": obj.spilled_path}
        if obj.locations or obj.spilled_path:
            return {"status": "remote"}  # caller must _ensure_local first
        return {"status": "lost"}

    # ------------------------------------------------- cross-node transfer
    def _source_for(self, obj: ObjectState) -> Optional[dict]:
        """Pick the LEAST-LOADED live copy (each completed pull mints a new
        copy, so concurrent fan-out self-organizes into a broadcast tree —
        reference analog: `PushManager` chunked push + location-aware pulls);
        falls back to the spill file."""
        best = None
        best_load = None
        for nid, name in obj.locations.items():
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                continue
            load = self._src_active.get(nid, 0)
            if best is None or load < best_load:
                addr = (
                    f"{self.node_ip}:{self.port}" if nid == HEAD_NODE
                    else node.fetch_addr
                )
                bulk = self._bulk_addr if nid == HEAD_NODE else node.bulk_addr
                best = {"addr": addr, "name": name, "node": nid, "bulk": bulk}
                best_load = load
        if best is not None:
            return best
        if obj.spilled_path is not None:
            nid = obj.spilled_node
            node = self.nodes.get(nid)
            if node is not None and (nid == HEAD_NODE or node.alive):
                addr = f"{self.node_ip}:{self.port}" if nid == HEAD_NODE else node.fetch_addr
                bulk = self._bulk_addr if nid == HEAD_NODE else node.bulk_addr
                return {"addr": addr, "path": obj.spilled_path, "node": nid,
                        "bulk": bulk}
        return None

    async def _ensure_local(self, node_id: str, hex_id: str):
        """Materialize a ready object on `node_id` (controller-directed pull —
        reference analog: `PullManager` asking the owner's `PushManager`)."""
        obj = self._obj(hex_id)
        if obj.inline is not None or node_id in obj.locations:
            return
        if (obj.size or 0) >= (1 << 30) and rt_config.get("transfer_log_big"):
            # Stderr diagnostic (session log): big-object transfer routing.
            print(
                f"ensure_local node={node_id} id={hex_id[:8]} "
                f"size={(obj.size or 0) >> 20}MiB",
                flush=True, file=__import__("sys").stderr,
            )
        if obj.spilled_path is not None and obj.spilled_node == node_id:
            return
        key = (node_id, hex_id)
        fut = self._pulls.get(key)
        if fut is not None:
            await fut
            return
        fut = asyncio.get_running_loop().create_future()
        self._pulls[key] = fut
        src = None
        try:
            # Broadcast shaping: wait while every source is already serving
            # its quota of pulls — each completed pull adds a copy, so
            # waiters fan out over fresh sources (binomial-tree growth)
            # instead of hammering the origin N-wide.
            per_src = rt_config.get("transfer_pulls_per_source")
            while True:
                src = self._source_for(obj)
                if src is None:
                    raise RuntimeError(f"object {hex_id[:12]} has no live copy")
                if self._src_active.get(src["node"], 0) < per_src:
                    break
                waiter = asyncio.get_running_loop().create_future()
                self._transfer_waiters.append(waiter)
                await waiter
                if node_id in obj.locations:  # a racer materialized it here
                    fut.set_result(None)
                    return
            self._src_active[src["node"]] = self._src_active.get(src["node"], 0) + 1
            try:
                # Deadline scales with size AND with possible queueing behind
                # the destination's pull-admission quota (the per-chunk
                # progress deadline lives agent-side; this is a backstop).
                timeout = rt_config.get("pull_timeout_s") + (
                    obj.size * (1 + rt_config.get("transfer_max_pulls"))
                    / (16 * 1024 * 1024) if obj.size else 0.0
                )
                if node_id == HEAD_NODE:
                    name, size = await self._fetch_into_head(
                        dict(src, id=hex_id), obj.size
                    )
                    self.store_bytes_used += size
                    self._maybe_spill()  # pulls count against the memory cap
                else:
                    node = self.nodes[node_id]
                    req = {"type": "pull_object", "id": hex_id,
                           "addr": src["addr"], "size": obj.size or 0,
                           "bulk": src.get("bulk", "")}
                    if "name" in src:
                        req["name"] = src["name"]
                    else:
                        req["path"] = src["path"]
                    resp = await node.conn.request(req, timeout=timeout)
                    if not resp.get("ok"):
                        raise RuntimeError(f"pull failed: {resp.get('error')}")
                    name = resp["name"]
            finally:
                self._src_active[src["node"]] -= 1
                waiters, self._transfer_waiters = self._transfer_waiters, []
                for w in waiters:
                    if not w.done():
                        w.set_result(None)
            obj.locations[node_id] = name
            self._event("object_transferred", object=hex_id, to=node_id, src=src["node"])
            fut.set_result(None)
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)
            # Consume the exception if nobody else awaits this future.
            fut.exception()
            raise
        finally:
            self._pulls.pop(key, None)

    async def _fetch_into_head(self, src: dict, size_hint: int = 0):
        """Materialize a remote object in the HEAD store — the same chunked
        pull client the agents use (streams into shm; no heap staging).
        Returns (name, size)."""
        from .node_agent import pull_chunked

        hex_id = src.get("id", "")
        if src["node"] == HEAD_NODE:
            if "name" in src:
                return src["name"], self.local_store.raw_size(src["name"])
            with open(src["path"], "rb") as f:
                data = f.read()
            return self.local_store.create_raw(hex_id, data)
        conn = self._fetch_conns.get(src["node"])
        if conn is None or conn._closed:
            host, port = src["addr"].rsplit(":", 1)
            reader, writer = await open_rpc_connection(host, int(port))
            conn = Connection(reader, writer)
            conn.start()
            self._fetch_conns[src["node"]] = conn
        where = {"name": src["name"]} if "name" in src else {"path": src["path"]}
        if src.get("bulk"):
            where["bulk"] = src["bulk"]
        return await pull_chunked(
            conn, where, self.local_store, hex_id, size_hint=size_hint
        )

    async def h_stat_object(self, conn, meta, msg):
        from .node_agent import serve_fetch

        try:
            return serve_fetch(self.local_store, dict(msg, type="stat_object"))
        except Exception as e:  # noqa: BLE001
            return {"error": repr(e)}

    async def h_fetch_chunk(self, conn, meta, msg):
        from .node_agent import serve_fetch

        try:
            return serve_fetch(self.local_store, dict(msg, type="fetch_chunk"))
        except Exception as e:  # noqa: BLE001
            return {"error": repr(e)}

    async def h_fetch_object(self, conn, meta, msg):
        """Serve head-node object bytes to a pulling agent."""
        try:
            if msg.get("name"):
                data = self.local_store.read_raw(msg["name"])
            else:
                with open(msg["path"], "rb") as f:
                    data = f.read()
            return {"data": data}
        except Exception as e:  # noqa: BLE001
            return {"error": repr(e)}

    async def h_put_inline(self, conn, meta, msg):
        self._mark_ready(
            msg["id"], inline=msg["data"], size=len(msg["data"]),
            contains=msg.get("contains"),
        )
        return {"ok": True}

    async def h_put_data(self, conn, meta, msg):
        """Client-mode put of a large frame: store in the HEAD arena so it is
        accounted (store_bytes_used) and spillable like any worker object."""
        name, size = self.local_store.create_raw(msg["id"], msg["data"])
        self._mark_ready(
            msg["id"], shm_name=name, size=size, contains=msg.get("contains")
        )
        return {"ok": True}

    async def h_register_object(self, conn, meta, msg):
        self._mark_ready(
            msg["id"], shm_name=msg["name"], size=msg["size"],
            node_id=meta.get("node_id") or HEAD_NODE,
            contains=msg.get("contains"),
        )
        return {"ok": True}

    async def _wait_ready(self, obj: ObjectState, deadline: Optional[float]) -> bool:
        """Wait for an object's next readiness event (shared deadline across
        attempts). _mark_ready clears the event list; on timeout we remove
        ourselves so never-produced objects don't accumulate dead events."""
        ev = asyncio.Event()
        obj.events.append(ev)
        try:
            if deadline is None:
                await ev.wait()
            else:
                await asyncio.wait_for(ev.wait(), max(0.0, deadline - time.monotonic()))
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            if ev in obj.events:
                obj.events.remove(ev)

    async def h_get_object(self, conn, meta, msg):
        return await self._get_object_payload(
            msg["id"], msg.get("timeout"), meta.get("node_id") or HEAD_NODE
        )

    async def h_get_objects(self, conn, meta, msg):
        """Batched resolve: one RPC for N refs (the reference's
        `CoreWorker::Get` takes the whole id list for the same reason —
        per-object round trips dominate many-ref gets)."""
        node_id = meta.get("node_id") or HEAD_NODE
        timeout = msg.get("timeout")
        payloads = await asyncio.gather(
            *(self._get_object_payload(h, timeout, node_id) for h in msg["ids"])
        )
        return {"locations": payloads}

    async def _get_object_payload(self, hex_id: str, timeout, node_id: str):
        deadline = None if timeout is None else time.monotonic() + timeout
        obj = self._obj(hex_id)
        if obj.status != "ready" and not await self._wait_ready(obj, deadline):
            return {"status": "timeout"}
        for _ in range(4):  # transfer, with lineage re-execution on loss
            payload = self._location_payload(obj, node_id)
            if payload["status"] == "remote":
                try:
                    await self._ensure_local(node_id, hex_id)
                except Exception:  # noqa: BLE001
                    continue  # copies vanished mid-pull; re-evaluate
                payload = self._location_payload(obj, node_id)
            if payload["status"] != "lost":
                return payload
            if not self._reconstruct_object(hex_id):
                return payload
            # Creating task resubmitted — wait for the new copy.
            if not await self._wait_ready(obj, deadline):
                return {"status": "timeout"}
        return {"status": "lost"}

    def _object_source(self, hex_id: str) -> Optional[dict]:
        """Data-plane span reads: resolve a live servable copy of an object
        to (bulk addr, store name, size) so a consumer can pull just ITS
        span of a block segment over the bulk plane (`data/transport.py`)
        instead of materializing the whole object locally. Read-only; None
        when the object is inline, spilled-only, or unknown (the caller
        falls back to a plain get)."""
        obj = self.objects.get(hex_id)
        if obj is None or obj.status != "ready" or obj.inline is not None:
            return None
        src = self._source_for(obj)
        if src is None or not src.get("bulk") or not src.get("name"):
            return None
        return {"bulk": src["bulk"], "name": src["name"],
                "node": src["node"], "size": obj.size}

    async def h_object_sources(self, conn, meta, msg):
        """Batched _object_source: one RPC resolves every map segment a
        reduce task will read (per-object round trips were measurably the
        whole cost of the transport path on small exchanges)."""
        return {"sources": [self._object_source(h) for h in msg["ids"]]}

    async def h_wait_objects(self, conn, meta, msg):
        ids: List[str] = msg["ids"]
        num_returns: int = msg["num_returns"]
        timeout = msg.get("timeout")
        deadline = None if timeout is None else time.monotonic() + timeout

        def ready_ids():
            return [h for h in ids if self.objects.get(h) and self.objects[h].status == "ready"]

        # Register one event per not-ready object up front; wake on any.
        registered: List[Tuple[ObjectState, asyncio.Event]] = []
        waiters: Dict[asyncio.Task, None] = {}
        try:
            for h in ids:
                obj = self._obj(h)
                if obj.status != "ready":
                    ev = asyncio.Event()
                    obj.events.append(ev)
                    registered.append((obj, ev))
                    waiters[asyncio.ensure_future(ev.wait())] = None
            while True:
                ready = ready_ids()
                if len(ready) >= num_returns or not waiters:
                    return {"ready": ready}
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return {"ready": ready}
                done, _ = await asyncio.wait(
                    list(waiters), timeout=remaining, return_when=asyncio.FIRST_COMPLETED
                )
                if not done:
                    return {"ready": ready_ids()}
                for t in done:
                    waiters.pop(t, None)
        finally:
            for t in waiters:
                t.cancel()
            for obj, ev in registered:
                if ev in obj.events:
                    obj.events.remove(ev)

    async def h_free_objects(self, conn, meta, msg):
        for hex_id in msg["ids"]:
            self._free_object(hex_id)
        return {"ok": True}

    def _drop_copies(self, hex_id: str):
        """Release every physical copy (shm on all nodes + spill file) while
        keeping the directory entry."""
        obj = self.objects.get(hex_id)
        if obj is None:
            return
        for nid, name in list(obj.locations.items()):
            if nid == HEAD_NODE:
                self.store_bytes_used -= obj.size
                self.local_store.release(name, unlink=True)
            else:
                node = self.nodes.get(nid)
                if node is not None and node.alive and node.conn is not None:
                    asyncio.ensure_future(
                        node.conn.send({"type": "free_object", "name": name})
                    )
        obj.locations.clear()
        if obj.spilled_path:
            try:
                os.unlink(obj.spilled_path)
            except OSError:
                pass
            obj.spilled_path = None
        obj.inline = None

    def _free_object(self, hex_id: str):
        self._drop_copies(hex_id)
        obj = self.objects.pop(hex_id, None)
        if obj is not None:
            # Tombstone: replay must not resurrect a directory entry whose
            # arena segment is already unlinked.
            self._wal_append("object_freed", id=hex_id)
        self._gc_candidates.discard(hex_id)
        if obj is not None:
            for h in obj.contains:  # container gone → nested refs unpin
                inner = self.objects.get(h)
                if inner is not None:
                    inner.pinned = max(0, inner.pinned - 1)
                    self._maybe_gc(h)

    # -------------------------------------------------- distributed refcount
    async def h_update_refs(self, conn, meta, msg):
        """Batched 0↔1 ref transitions from one process (reference analog:
        `WaitForRefRemoved` batching via pubsub — `pubsub/README.md:7-27`).
        Adds are processed before releases, so an add+release pair in one
        batch (a short-lived ref) still marks the object ever_held."""
        conn_id = meta.get("conn_id")
        held = self._conn_refs.setdefault(conn_id, set())
        for hex_id in msg.get("add", ()):
            obj = self._obj(hex_id)
            obj.holders.add(conn_id)
            obj.ever_held = True
            held.add(hex_id)
        for hex_id in msg.get("release", ()):
            held.discard(hex_id)
            obj = self.objects.get(hex_id)
            if obj is not None:
                obj.holders.discard(conn_id)
                self._maybe_gc(hex_id)
        return None

    _GC_GRACE = property(lambda self: rt_config.get("gc_grace_s"))
    # must stay > 2× the client flush interval so in-flight adds land

    def _maybe_gc(self, hex_id: str):
        """Schedule a holderless, unpinned object for the GC sweep. The grace
        window absorbs the cross-process handoff race (a receiver's batched
        add-ref can trail the sender's release by up to the flush interval)."""
        obj = self.objects.get(hex_id)
        if (
            obj is None
            or not obj.ever_held
            or obj.holders
            or obj.pinned > 0
            or obj.events
            or obj.dependents
        ):
            return
        if obj.status == "ready" or not obj.expected:
            obj.gc_at = time.monotonic() + self._GC_GRACE
            self._gc_candidates.add(hex_id)

    async def _gc_loop(self):
        while not self._shutdown_event.is_set():
            await asyncio.sleep(rt_config.get("gc_sweep_interval_s"))
            now = time.monotonic()
            for hex_id in list(self._gc_candidates):
                obj = self.objects.get(hex_id)
                if obj is None:
                    self._gc_candidates.discard(hex_id)
                    continue
                if (
                    obj.holders
                    or obj.pinned > 0
                    or obj.events
                    or obj.dependents
                    or not obj.ever_held
                ):
                    self._gc_candidates.discard(hex_id)  # re-added on release
                    continue
                if now < obj.gc_at:
                    continue
                if obj.status == "ready":
                    size = obj.size
                    self._free_object(hex_id)
                    self._event("object_gc", object=hex_id, size=size)
                elif not obj.expected:
                    # Zombie entry (late add after free) — drop the state.
                    self.objects.pop(hex_id, None)
                    self._gc_candidates.discard(hex_id)

    def _pin_args(self, spec: TaskSpec):
        for oid in spec.arg_refs:
            self._obj(oid.hex()).pinned += 1

    def _unpin_args(self, spec: TaskSpec):
        for oid in spec.arg_refs:
            obj = self.objects.get(oid.hex())
            if obj is not None:
                obj.pinned = max(0, obj.pinned - 1)
                self._maybe_gc(oid.hex())

    # ------------------------------------------------------------ spilling
    def _maybe_spill(self):
        """Head-node spill (remote arenas evict via their own LRU)."""
        if self.store_bytes_used <= self.object_store_memory:
            return
        candidates = sorted(
            (
                (o.last_access, h, o)
                for h, o in self.objects.items()
                if o.status == "ready" and HEAD_NODE in o.locations
            ),
        )
        for _, hex_id, obj in candidates:
            if self.store_bytes_used <= self.object_store_memory * 0.8:
                break
            try:
                path = self.local_store.spill(obj.locations[HEAD_NODE], self.spill_dir)
            except FileNotFoundError:
                continue
            self.store_bytes_used -= obj.size
            obj.spilled_path = path
            obj.spilled_node = HEAD_NODE
            del obj.locations[HEAD_NODE]
            self._event("object_spilled", object=hex_id, size=obj.size)

    # --------------------------------------------------------------- tasks
    def _infeasible(self, demand: Dict[str, float]) -> Dict[str, float]:
        """A demand is infeasible iff NO single alive node could ever fit it
        (reference: `ClusterResourceScheduler::IsSchedulableOnNode`)."""
        for n in self.nodes.values():
            if n.alive and all(n.total.get(k, 0.0) >= v for k, v in demand.items()):
                return {}
        return dict(demand)

    def _cluster_totals(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.total.items():
                total[k] = total.get(k, 0.0) + v
        return total

    async def h_submit_task(self, conn, meta, msg):
        spec: TaskSpec = spec_from_proto_bytes(msg["spec"])
        bad = self._infeasible(spec.resources)
        if bad:
            err = TaskError(
                RuntimeError(
                    f"Task {spec.name} demands {bad} but no node can fit it "
                    f"(cluster total {self._cluster_totals()}) — infeasible, "
                    f"will never schedule."
                ),
                "",
                spec.name,
            )
            for oid in spec.return_ids:
                self._store_error_object(oid.hex(), err)
            return {"ok": False}
        self._pin_args(spec)
        self._remember_lineage(spec)
        self._expect_returns(spec)
        pt = PendingTask(spec=spec, retries_left=spec.options.max_retries)
        self._event(
            "task_submitted", task=spec.task_id.hex(), name=spec.name,
            parent=spec.parent_task_id.hex() if spec.parent_task_id else None,
            trace=spec.trace_id or None,
        )
        self._enqueue(pt)
        self._schedule()
        return {"ok": True}

    def _expect_returns(self, spec: TaskSpec):
        """Create directory entries for a task's returns up front, flagged
        `expected` — distinguishes 'result is coming' from zombie state, and
        guarantees early add-refs land on real entries."""
        for oid in spec.return_ids:
            self._obj(oid.hex()).expected = True

    def _remember_lineage(self, spec: TaskSpec):
        """Keep the creating spec so lost outputs can be re-executed; bounded
        (reference: lineage pinning budget in `reference_count.h`)."""
        self.lineage[spec.task_id.hex()] = spec
        while len(self.lineage) > self._lineage_cap:
            self.lineage.pop(next(iter(self.lineage)))

    def _reconstruct_object(self, hex_id: str) -> bool:
        """Resubmit the creating task of a lost object (reference analog:
        `ObjectRecoveryManager::ReconstructObject`, `object_recovery_manager.cc:141`).
        ObjectID's first 24 bytes ARE the creating TaskID."""
        obj = self.objects.get(hex_id)
        if obj is None or not obj.is_lost():
            return obj is not None
        spec = self.lineage.get(hex_id[:48])
        if spec is None or obj.recon_attempts >= 3:
            return False
        if hex_id not in {oid.hex() for oid in spec.return_ids}:
            # A put() object of that task — re-running would mint a fresh
            # object id, not this one. Not reconstructable (reference has the
            # same rule: only task returns are recoverable).
            return False
        # Deps must be producible first: a GC-freed dep (entry popped, or a
        # zombie pending entry) is re-materialized through ITS lineage before
        # this task is parked waiting on it — else the wait never resolves.
        for oid in spec.arg_refs:
            h = oid.hex()
            dep = self.objects.get(h)
            if dep is None or (dep.status == "pending" and not dep.expected):
                d = self._obj(h)
                d.status = "ready"  # lost-shaped: no copies → is_lost()
                d.inline = None
                d.locations.clear()
                d.spilled_path = None
                if not self._reconstruct_object(h):
                    d.status = "pending"
                    return False
            elif dep.is_lost() and not self._reconstruct_object(h):
                return False
        obj.recon_attempts += 1
        for oid in spec.return_ids:
            o = self._obj(oid.hex())
            self._drop_copies(oid.hex())  # free live siblings before reset
            o.status = "pending"
            o.expected = True
        self._pin_args(spec)
        self._event("object_reconstruction", object=hex_id, task=spec.task_id.hex())
        self._enqueue(PendingTask(spec=spec, retries_left=spec.options.max_retries))
        self._schedule()
        return True

    def _enqueue(self, pt: PendingTask):
        spec = pt.spec
        deps = set()
        for oid in spec.arg_refs:
            h = oid.hex()
            obj = self._obj(h)
            if obj.status != "ready":
                deps.add(h)
                obj.dependents.add(spec.task_id.hex())
        pt.deps_remaining = deps
        if deps:
            self.waiting_tasks[spec.task_id.hex()] = pt
        else:
            self.ready_queue.append(pt)

    def _fits_node(self, node: NodeState, demand: Dict[str, float]) -> bool:
        return node.alive and all(
            node.available.get(k, 0.0) + 1e-9 >= v for k, v in demand.items()
        )

    def _acquire(self, node: NodeState, demand: Dict[str, float]):
        node.last_active = time.monotonic()
        for k, v in demand.items():
            node.available[k] = node.available.get(k, 0.0) - v

    def _release(self, node: NodeState, demand: Dict[str, float]):
        node.last_active = time.monotonic()
        for k, v in demand.items():
            node.available[k] = node.available.get(k, 0.0) + v

    # --- grants may come from node capacity OR a PG bundle reservation ---
    def _grant_apply(self, ws: WorkerState, sign: float):
        """Move ws.assigned into (+1) or out of (-1) its capacity source."""
        if ws.assigned_pg is not None:
            pg_hex, bidx = ws.assigned_pg
            pg = self.pgs.get(pg_hex)
            if pg is not None and bidx < len(pg.get("bundle_avail", [])):
                b = pg["bundle_avail"][bidx]
                for k, v in ws.assigned.items():
                    b[k] = b.get(k, 0.0) + sign * v
        else:
            node = self.nodes.get(ws.node_id)
            if node is not None:
                if sign > 0:
                    self._release(node, ws.assigned)
                else:
                    self._acquire(node, ws.assigned)

    def _grant_release(self, ws: WorkerState):
        self._grant_apply(ws, +1.0)
        ws.assigned = {}
        ws.assigned_pg = None

    def _grant_release_keep(self, ws: WorkerState):
        """Blocked-worker release: free capacity but KEEP ws.assigned/PG so
        worker_unblocked can restore the grant."""
        self._grant_apply(ws, +1.0)

    def _grant_reacquire(self, ws: WorkerState):
        """Inverse of the blocked-release (worker_unblocked)."""
        self._grant_apply(ws, -1.0)

    def _pg_fit(
        self, spec: TaskSpec, strat: PlacementGroupSchedulingStrategy
    ) -> Optional[Tuple[str, int, NodeState]]:
        """Find (pg_hex, bundle_index, node) serving this PG task's demand.
        Reference analog: bundle resources in
        `PlacementGroupResourceManager` (raylet)."""
        pg_obj = strat.placement_group
        pg_hex = pg_obj.id.hex() if hasattr(pg_obj, "id") else str(pg_obj)
        pg = self.pgs.get(pg_hex)
        if pg is None or not pg["ready"]:
            return None
        demand = spec.resources
        idxs = (
            [strat.placement_group_bundle_index]
            if strat.placement_group_bundle_index >= 0
            else range(len(pg["bundles"]))
        )
        for i in idxs:
            if i >= len(pg["bundle_avail"]):
                continue
            avail = pg["bundle_avail"][i]
            if all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items()):
                node = self.nodes.get(pg["bundle_nodes"][i])
                if node is not None and node.alive:
                    return pg_hex, i, node
        return None

    def _idle_worker(
        self, node_id: str, need_tpu: bool = False, cache: Optional[dict] = None,
        env_key: str = "",
    ) -> Optional[WorkerState]:
        if cache is not None:
            # Per-pass index (built once in _schedule): O(1) per lookup
            # instead of an O(workers) scan per queued task per event.
            idx = cache.get("idle")
            if idx is None:
                idx = cache["idle"] = {"cpu": {}, "tpu": {}}
                for ws in self.workers.values():
                    if ws.state == IDLE:
                        kind = "tpu" if ws.has_tpu else "cpu"
                        idx[kind].setdefault(
                            (ws.node_id, ws.env_key), []
                        ).append(ws)
            def take(lst):
                # Validate against live state — entries can go stale if any
                # path mutates workers outside _cache_remove_idle.
                while lst and lst[-1].state != IDLE:
                    lst.pop()
                return lst[-1] if lst else None

            slot = (node_id, env_key)
            if need_tpu:
                return take(idx["tpu"].get(slot) or [])
            got = take(idx["cpu"].get(slot) or [])
            if got is not None:
                return got
            # Fallback: TPU worker takes CPU task (same isolation only).
            return take(idx["tpu"].get(slot) or [])
        fallback = None
        for ws in self.workers.values():
            if ws.state != IDLE or ws.node_id != node_id or ws.env_key != env_key:
                continue
            if need_tpu:
                if ws.has_tpu:
                    return ws
            else:
                # Prefer CPU workers; keep TPU workers free for TPU tasks.
                if not ws.has_tpu:
                    return ws
                fallback = ws
        return None if need_tpu else fallback

    @staticmethod
    def _cache_remove_idle(cache: Optional[dict], ws: WorkerState):
        if cache is None:
            return
        idx = cache.get("idle")
        if idx is None:
            return
        kind = "tpu" if ws.has_tpu else "cpu"
        lst = idx[kind].get((ws.node_id, ws.env_key))
        if not lst:
            return
        if lst[-1] is ws:  # grants take from the tail — O(1) common case
            lst.pop()
        elif ws in lst:
            lst.remove(ws)

    def _candidate_nodes(
        self, spec: TaskSpec, cache: Optional[dict] = None
    ) -> List[NodeState]:
        """Order nodes per the task's scheduling strategy.

        Reference analogs: `HybridSchedulingPolicy` (pack until threshold,
        then least-utilized — `hybrid_scheduling_policy.h:50`),
        `SpreadSchedulingPolicy`, `NodeAffinitySchedulingPolicy`.

        With `cache` (one dict per _schedule pass) the hybrid/sorted
        orderings are computed ONCE per pass, not per queued task per event
        — profiling showed this exact path eating ~85% of controller CPU
        under a deep ready queue (540k calls / 1.6M utilization() evals for
        a 2k-task benchmark).
        """
        strat = spec.options.scheduling_strategy
        if cache is not None and "alive_sorted" in cache:
            alive_sorted = cache["alive_sorted"]
        else:
            alive_sorted = sorted(
                (n for n in self.nodes.values() if n.alive),
                key=lambda n: n.node_id,
            )
            if cache is not None:
                cache["alive_sorted"] = alive_sorted
        if isinstance(strat, NodeAffinitySchedulingStrategy) and strat.node_id:
            pinned = [n for n in alive_sorted if n.node_id == strat.node_id]
            if not strat.soft:
                return pinned
            # Soft-affinity spill follows the HYBRID order, not node-id
            # order: the data plane's locality scorer pins reduce/consumer
            # tasks softly to the node holding their source bytes — when
            # that node is full/dead the task should degrade to the same
            # pack-then-least-utilized policy as default scheduling instead
            # of piling onto whatever node sorts first.
            return pinned + [
                n for n in self._hybrid_order(alive_sorted, cache)
                if n.node_id != strat.node_id
            ]
        if isinstance(strat, NodeLabelSchedulingStrategy):
            # Hard label constraints: only matching nodes are candidates
            # (reference: `NodeLabelSchedulingPolicy`).
            return [
                n for n in alive_sorted
                if all(n.labels.get(k) == str(v) for k, v in strat.hard.items())
            ]
        if isinstance(strat, SpreadSchedulingStrategy):
            # True round-robin: each spread decision starts one node further
            # along, so consecutive tasks land on distinct nodes (reference:
            # `SpreadSchedulingPolicy` round-robins over FEASIBLE nodes).
            # Nodes that can never hold the demand (a 0-CPU head) are left
            # out of the rotation — rotating onto one silently re-packs its
            # share onto whichever node sorts next, skewing the spread.
            feasible = [
                n for n in alive_sorted
                if all(n.total.get(k, 0.0) >= v
                       for k, v in spec.resources.items())
            ] or alive_sorted
            self._spread_rr += 1
            r = self._spread_rr % len(feasible) if feasible else 0
            return feasible[r:] + feasible[:r]
        # Hybrid default: pack in node-id order while below the utilization
        # threshold, then least-utilized.
        return self._hybrid_order(alive_sorted, cache)

    def _hybrid_order(
        self, alive_sorted: List[NodeState], cache: Optional[dict]
    ) -> List[NodeState]:
        """Pack-until-threshold then least-utilized (reference:
        `hybrid_scheduling_policy.h:50`), cached once per schedule pass."""
        if cache is not None and "hybrid" in cache:
            return cache["hybrid"]
        packable = [n for n in alive_sorted if n.utilization() < 0.8]
        rest = sorted(
            (n for n in alive_sorted if n.utilization() >= 0.8),
            key=lambda n: n.utilization(),
        )
        out = packable + rest
        if cache is not None:
            cache["hybrid"] = out
        return out

    def _deps_payload(self, spec: TaskSpec, node_id: str) -> dict:
        locs = {}
        for oid in spec.arg_refs:
            h = oid.hex()
            locs[h] = self._location_payload(self.objects[h], node_id)
        return locs

    async def _dispatch(self, node: NodeState, ws: WorkerState, pt: PendingTask):
        """Send a task to its granted worker, first materializing remote deps
        on that worker's node (controller-directed pull)."""
        spec = pt.spec
        task_hex = spec.task_id.hex()
        if spec.task_type == TaskType.ACTOR_CREATION_TASK and spec.actor_id:
            astate = self.actors.get(spec.actor_id.hex())
            if (
                astate is not None
                and astate.state == "alive"
                and astate.worker_id
                and astate.worker_id != ws.worker_id
            ):
                # Failover race resolved in the actor's favor: restore
                # requeued this creation (it looked never-started), but the
                # surviving worker re-adopted first. Dropping here is what
                # keeps the chaos gate's "zero duplicated actors" honest.
                self.running.pop(task_hex, None)
                ws.state = IDLE
                ws.current_task = None
                ws.actor_hex = None
                self._grant_release(ws)
                self._unpin_args(spec)
                self._event("actor_recreate_dropped", actor=spec.actor_id.hex())
                self._schedule()
                return
        try:
            await asyncio.gather(
                *(self._ensure_local(node.node_id, oid.hex()) for oid in spec.arg_refs)
            )
        except Exception as e:  # noqa: BLE001
            # A dep's every copy died mid-transfer. Return the grant, then
            # try lineage reconstruction before declaring the task failed.
            self.running.pop(task_hex, None)
            was_actor = ws.state == ACTOR
            ws.state = IDLE
            ws.current_task = None
            ws.actor_hex = None
            self._grant_release(ws)
            lost = [
                oid.hex()
                for oid in spec.arg_refs
                if (o := self.objects.get(oid.hex())) is not None and o.is_lost()
            ]
            if lost and all(self._reconstruct_object(h) for h in lost):
                # Deps are re-executing; requeue — _enqueue re-registers the
                # (now pending) deps so the task waits for the new copies.
                if was_actor and spec.actor_id is not None:
                    astate = self.actors.get(spec.actor_id.hex())
                    if astate is not None:
                        self._set_actor_state(astate, "pending")
                self._event("task_requeued_for_reconstruction", task=task_hex)
                self._enqueue(pt)
                self._schedule()
                return
            err = TaskError(
                RuntimeError(f"dependency transfer failed: {e}"), "", spec.name
            )
            self._unpin_args(spec)
            if was_actor and spec.actor_id is not None:
                astate = self.actors.get(spec.actor_id.hex())
                if astate is not None:
                    astate.init_error = err
                    self._set_actor_state(astate, "dead")
                    self._drain_actor_queue(astate, err)
            for oid in spec.return_ids:
                self._store_error_object(oid.hex(), err)
            self._schedule()
            return
        msg_type = (
            "create_actor"
            if spec.task_type == TaskType.ACTOR_CREATION_TASK
            else "execute_task"
        )
        try:
            # post(): batched fire-and-forget — a dispatch burst rides one
            # writer wake-up; a dead conn raises and the worker-death path
            # (already in flight via on_close) requeues from self.running.
            ws.conn.post(
                {
                    "type": msg_type,
                    "spec": spec_to_proto_bytes(spec),
                    "deps": self._deps_payload(spec, node.node_id),
                }
            )
        except ConnectionError:
            return
        self._event("task_dispatched", task=task_hex, worker=ws.worker_id,
                     node=node.node_id)

    # ----------------------------------------------- two-level scheduling
    def _handoff_cap(self, node: NodeState) -> int:
        return max(
            int(node.total.get("CPU", 0)), 1
        ) * rt_config.get("local_dispatch_depth")

    def _try_handoff(self, pt: PendingTask, preferred: Optional[NodeState]) -> bool:
        """Hand a queued plain task to a node agent's LocalDispatcher
        instead of keeping it head-resident (reference: ClusterTaskManager
        node pick + spillback of the QUEUE, not just of running tasks).

        Only the overflow path takes this: tasks that found an idle worker
        were dispatched centrally already, so agents receive exactly the
        backlog — the population whose dispatch otherwise serializes
        through this loop."""
        spec = pt.spec
        if not rt_config.get("local_dispatch"):
            return False
        if spec.task_type != TaskType.NORMAL_TASK:
            return False
        if _task_env_key(spec):
            return False  # isolated tasks need env-keyed workers, not leases
        demand = spec.resources
        # The dispatcher executes on generic CPU:1 leases — only tasks whose
        # demand a CPU:1 lease actually covers may ride the plane. Custom
        # resources / multi-CPU shapes keep central accounting (which debits
        # node.available per task).
        if any(k != "CPU" for k in demand) or demand.get("CPU", 0) > 1:
            return False
        strat = spec.options.scheduling_strategy
        if not isinstance(
            strat,
            (DefaultSchedulingStrategy, SpreadSchedulingStrategy,
             NodeAffinitySchedulingStrategy),
        ):
            return False
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            node = self.nodes.get(strat.node_id)
            candidates = [node] if node is not None else []
        elif pt.pinned_node is not None:
            node = self.nodes.get(pt.pinned_node)
            candidates = [node] if node is not None else []
        elif preferred is not None:
            candidates = [preferred] + [
                n for n in self.nodes.values() if n is not preferred
            ]
        else:
            candidates = list(self.nodes.values())
        best = None
        for node in candidates:
            if (
                node is None or not node.alive or node.conn is None
                or not node.dispatch
                or node.handoff_inflight >= self._handoff_cap(node)
                # The dispatcher executes on CPU:1 leases — a node that can
                # never grant one (e.g. TPU-only, CPU:0) would strand even
                # num_cpus=0 tasks in 10s spill-back bounces.
                or node.total.get("CPU", 0) < 1
                or not all(node.total.get(k, 0) >= v for k, v in demand.items())
            ):
                continue
            if best is None or node.handoff_inflight < best.handoff_inflight:
                best = node
            if node is preferred or pt.pinned_node is not None:
                break  # placement-constrained: first viable wins
        if best is None:
            return False
        task_hex = spec.task_id.hex()
        self.running[task_hex] = (f"@{best.node_id}", pt)
        best.handoff_inflight += 1
        self._event("task_handoff", task=task_hex, node=best.node_id)
        if not spec.arg_refs:
            try:
                best.conn.post({
                    "type": "enqueue_task", "task": task_hex,
                    "spec": spec_to_proto_bytes(spec), "deps": {},
                })
            except Exception:  # noqa: BLE001 — conn died before alive flipped
                self.running.pop(task_hex, None)
                best.handoff_inflight = max(0, best.handoff_inflight - 1)
                return False
        else:
            asyncio.ensure_future(self._handoff_send(best, pt))
        return True

    async def _handoff_send(self, node: NodeState, pt: PendingTask):
        """Materialize args on the target node, then ship spec+deps — the
        agent dispatches with zero further head involvement."""
        spec = pt.spec
        task_hex = spec.task_id.hex()
        try:
            await asyncio.gather(
                *(self._ensure_local(node.node_id, oid.hex())
                  for oid in spec.arg_refs)
            )
            if task_hex in self.cancelled:
                # ray.cancel() landed while deps were in flight: h_cancel's
                # cancel_task post found nothing at the agent (the enqueue
                # hadn't shipped), so suppress the enqueue here or the task
                # would run uncancellably.
                self.running.pop(task_hex, None)
                node.handoff_inflight = max(0, node.handoff_inflight - 1)
                self._finish_cancelled(pt)
                self._schedule()
                return
            node.conn.post({
                "type": "enqueue_task", "task": task_hex,
                "spec": spec_to_proto_bytes(spec),
                "deps": self._deps_payload(spec, node.node_id),
            })
        except Exception as e:  # noqa: BLE001 — dep transfer / conn failure
            if self.running.pop(task_hex, None) is None:
                # Ownership already taken (node death requeued/retried the
                # task, or cancel finished it) — failing the returns here
                # would poison a retry that may yet succeed.
                return
            node.handoff_inflight = max(0, node.handoff_inflight - 1)
            lost = [
                oid.hex()
                for oid in spec.arg_refs
                if (o := self.objects.get(oid.hex())) is not None and o.is_lost()
            ]
            if lost and all(self._reconstruct_object(h) for h in lost):
                self._event("task_requeued_for_reconstruction", task=task_hex)
                self._enqueue(pt)
            else:
                err = TaskError(
                    RuntimeError(f"dependency transfer failed: {e}"), "",
                    spec.name,
                )
                self._unpin_args(spec)
                if spec.num_returns == -1:
                    self._fail_stream(spec, err)
                for oid in spec.return_ids:
                    self._store_error_object(oid.hex(), err)
            self._schedule()

    def _retry_or_fail(self, pt: PendingTask, task_hex: str, cause: str):
        """Shared worker-loss policy: consume a retry and requeue, else fail
        the returns (used by _on_worker_death and agent-reported losses)."""
        if task_hex in self.cancelled:
            self._finish_cancelled(pt)
            return
        if pt.retries_left > 0:
            pt.retries_left -= 1
            pt.spec.attempt_number += 1
            pt.pinned_node = None
            self._event("task_retry", task=task_hex)
            self._enqueue(pt)
            return
        err = TaskError(WorkerCrashedError(cause), "", pt.spec.name)
        self._unpin_args(pt.spec)
        if pt.spec.num_returns == -1:
            self._fail_stream(pt.spec, err)
        for oid in pt.spec.return_ids:
            self._store_error_object(oid.hex(), err)

    async def h_worker_spawn_failed(self, conn, meta, msg):
        """Agent couldn't even exec the isolated worker command (missing
        conda/podman) — fail the tasks waiting on that env."""
        worker_id = msg["worker_id"]
        key = self._worker_env_keys.get(worker_id, "")
        node = self.nodes.get(meta.get("node_id", ""))
        if node is not None and key:
            self._iso_spawn_failed(
                node, worker_id, {"key": key},
                msg.get("error", "spawn failed"), tpu=bool(msg.get("tpu")),
            )
            self._schedule()
        return None

    async def h_agent_task_lost(self, conn, meta, msg):
        """Agent-side dispatch saw the executing worker die (local worker
        loss is AGENT-observed for handed-off tasks — the head never granted
        that worker)."""
        entry = self.running.pop(msg["task"], None)
        if entry is None:
            return None
        node = self.nodes.get(meta.get("node_id", ""))
        if node is not None:
            node.handoff_inflight = max(0, node.handoff_inflight - 1)
        self._retry_or_fail(
            entry[1], msg["task"],
            f"Worker {msg.get('worker_id', '?')} died executing task",
        )
        self._schedule()
        return None

    async def h_agent_spillback(self, conn, meta, msg):
        """Agent could not serve queued tasks (no leases obtainable) — they
        come home for central placement (reference: spillback,
        `cluster_task_manager.h` ScheduleOnNode fallback)."""
        node = self.nodes.get(meta.get("node_id", ""))
        for task_hex in msg.get("tasks", []):
            entry = self.running.pop(task_hex, None)
            if entry is None:
                continue
            if node is not None:
                node.handoff_inflight = max(0, node.handoff_inflight - 1)
            pt = entry[1]
            pt.pinned_node = None
            if task_hex in self.cancelled:
                self._finish_cancelled(pt)
            else:
                self._enqueue(pt)
        self._schedule()
        return None

    async def h_agent_task_cancelled(self, conn, meta, msg):
        entry = self.running.pop(msg["task"], None)
        node = self.nodes.get(meta.get("node_id", ""))
        if node is not None:
            node.handoff_inflight = max(0, node.handoff_inflight - 1)
        if entry is not None:
            self._finish_cancelled(entry[1])
        return None

    def _schedule(self):
        """Request a scheduling pass, coalesced per event-loop drain.

        Deferral is the controller's lifecycle batching: every message in
        one socket read burst (a registration storm, a task_done wave) maps
        to ONE pass via call_soon instead of a pass per message. Callers
        observe the same semantics — handlers are async, so dispatch was
        never synchronous with the triggering message anyway.
        """
        if self._schedule_soon:
            return
        self._schedule_soon = True
        try:
            asyncio.get_running_loop().call_soon(self._schedule_tick)
        except RuntimeError:
            # No running loop (unit tests poking controller state
            # synchronously) — run the pass inline like the old path did.
            self._schedule_soon = False
            self._schedule_now()

    def _schedule_tick(self):
        self._schedule_soon = False
        self._schedule_now()

    def _schedule_now(self):
        """Run scheduling passes until quiescent.

        NON-REENTRANT: failure paths inside a pass (_fail_task →
        _mark_ready) call _schedule again; a nested pass would grant workers
        the outer pass still holds in its per-pass idle cache (double-grant).
        Nested calls just flag a rerun.
        """
        if self._scheduling:
            self._schedule_again = True
            return
        self._scheduling = True
        try:
            while True:
                self._schedule_again = False
                self._schedule_pass()
                if not self._schedule_again:
                    break
        finally:
            self._scheduling = False

    def _schedule_pass(self):
        """One scheduling pass (reference analog:
        `ClusterTaskManager::ScheduleAndDispatchTasks` (node pick) +
        `LocalTaskManager` (worker grant), collapsed)."""
        # Pending PGs first: capacity freed since the last pass may fit them
        # (reference: `SchedulePendingPlacementGroups` on resource change).
        if any(not pg["ready"] for pg in self.pgs.values()):
            self._retry_pending_pgs()
        made_progress = True
        # Per-pass scheduler cache: node orderings + idle-worker index
        # (invalidated per grant via _cache_remove_idle).
        cache: Dict[str, Any] = {}
        # Demand signatures that found NO capacity this pass: capacity only
        # shrinks within a pass, so identical demands behind them can skip
        # the node scan entirely (the dominant cost with a deep homogeneous
        # queue — profiling showed 800k _fits_node calls for a 3k-task run).
        # Value = node to aim a spawn hint at (None if infeasible everywhere).
        no_capacity: Dict[tuple, Optional[str]] = {}
        # node_id -> CPU workers wanted this pass; flushed bounded below so a
        # task waiting out a worker boot doesn't fork one per scheduling event.
        spawn_wanted: Dict[str, int] = {}
        # Actor creations wanting a worker — flushed with force=True (the
        # task-pool cap must not deadlock actor creation; each actor owns a
        # dedicated process).
        spawn_wanted_actors: Dict[str, int] = {}
        while made_progress and self.ready_queue:
            made_progress = False
            # Bounded head scan: dispatch FIFO, skipping over at most a small
            # window of blocked tasks (so a TPU task at the head can't starve
            # CPU tasks behind it, but a long queue isn't rescanned per event).
            scan = min(len(self.ready_queue), rt_config.get("scheduler_scan_window"))
            for _ in range(scan):
                if not self.ready_queue:  # prefetch may consume entries mid-scan
                    break
                pt = self.ready_queue.popleft()
                spec = pt.spec
                if spec.task_id.hex() in self.cancelled:
                    self._finish_cancelled(pt)
                    made_progress = True
                    continue
                demand = spec.resources
                need_tpu = demand.get(ACCELERATOR, 0) > 0  # reference: "TPU", ray_tpu/core/controller.py:2984
                env_key = _task_env_key(spec)
                chosen: Optional[Tuple[NodeState, WorkerState]] = None
                spawn_on: Optional[NodeState] = None
                pg_grant: Optional[Tuple[str, int]] = None
                strat = spec.options.scheduling_strategy
                if (
                    isinstance(strat, PlacementGroupSchedulingStrategy)
                    and strat.placement_group is not None
                ):
                    pg_obj = strat.placement_group
                    pg_state = self.pgs.get(
                        pg_obj.id.hex() if hasattr(pg_obj, "id") else str(pg_obj)
                    )
                    hard_fail = None
                    if pg_state is None:
                        hard_fail = "placement group was removed"
                    else:
                        bidx0 = strat.placement_group_bundle_index
                        idxs = (
                            [bidx0] if bidx0 >= 0 else range(len(pg_state["bundles"]))
                        )
                        if not any(
                            i < len(pg_state["bundles"])
                            and all(
                                pg_state["bundles"][i].get(k, 0.0) >= v
                                for k, v in demand.items()
                            )
                            for i in idxs
                        ):
                            hard_fail = (
                                f"demand {demand} exceeds the bundle capacity"
                            )
                    if hard_fail is not None:
                        self._fail_task(
                            pt,
                            TaskError(
                                RuntimeError(
                                    f"Task {spec.name} cannot schedule: {hard_fail}."
                                ),
                                "",
                                spec.name,
                            ),
                        )
                        made_progress = True
                        continue
                    fit = self._pg_fit(spec, strat)
                    if fit is None:
                        self.ready_queue.append(pt)  # bundle busy / placing
                        continue
                    pg_hex, bidx, node = fit
                    ws = self._idle_worker(node.node_id, need_tpu, cache, env_key)
                    if ws is None:
                        self.ready_queue.append(pt)
                        if env_key:
                            self._spawn_isolated(node, spec, tpu=need_tpu)
                        elif need_tpu:
                            self._spawn_worker(tpu=True, node=node)
                        else:
                            target = (
                                spawn_wanted_actors
                                if spec.task_type == TaskType.ACTOR_CREATION_TASK
                                else spawn_wanted
                            )
                            target[node.node_id] = (
                                target.get(node.node_id, 0) + 1
                            )
                        continue
                    avail = self.pgs[pg_hex]["bundle_avail"][bidx]
                    for k, v in demand.items():
                        avail[k] = avail.get(k, 0.0) - v
                    pg_grant = (pg_hex, bidx)
                    chosen = (node, ws)
                else:
                    # Spread/affinity COMMIT to the placement-correct node
                    # (spawn a worker there and wait); hybrid falls through to
                    # any node with an idle worker — packing tolerates it.
                    commit_first_fit = isinstance(
                        strat,
                        (SpreadSchedulingStrategy, NodeAffinitySchedulingStrategy),
                    )
                    sig = pt.sched_sig(need_tpu)
                    if sig is not None and sig in no_capacity:
                        # Same demand already found no central capacity this
                        # pass — the agent handoff plane is exactly for this
                        # backlog population.
                        hint_node = (
                            self.nodes.get(no_capacity[sig])
                            if no_capacity[sig] is not None else None
                        )
                        if self._try_handoff(pt, hint_node):
                            made_progress = True
                            continue
                        self.ready_queue.append(pt)
                        hint = no_capacity[sig]
                        if hint is not None and env_key:
                            hn = self.nodes.get(hint)
                            if hn is not None:
                                self._spawn_isolated(hn, spec, tpu=need_tpu)
                        elif hint is not None and not need_tpu:
                            target = (
                                spawn_wanted_actors
                                if spec.task_type == TaskType.ACTOR_CREATION_TASK
                                else spawn_wanted
                            )
                            target[hint] = target.get(hint, 0) + 1
                        continue
                    if pt.pinned_node is not None:
                        pin = self.nodes.get(pt.pinned_node)
                        candidates = [pin] if pin is not None and pin.alive else None
                        if candidates is None:
                            pt.pinned_node = None  # pinned node died — re-pick
                            candidates = self._candidate_nodes(spec, cache)
                    else:
                        candidates = self._candidate_nodes(spec, cache)
                    for node in candidates:
                        if not self._fits_node(node, demand):
                            continue
                        ws = self._idle_worker(node.node_id, need_tpu, cache, env_key)
                        if ws is None:
                            spawn_on = spawn_on or node
                            if commit_first_fit:
                                pt.pinned_node = node.node_id
                                break
                            continue
                        chosen = (node, ws)
                        break
                    if chosen is None:
                        if self._try_handoff(pt, spawn_on):
                            made_progress = True
                            continue
                        self.ready_queue.append(pt)
                        if sig is not None:
                            no_capacity[sig] = (
                                spawn_on.node_id if spawn_on is not None else None
                            )
                        if spawn_on is not None:
                            if env_key:
                                self._spawn_isolated(spawn_on, spec, tpu=need_tpu)
                            elif need_tpu:
                                self._spawn_worker(tpu=True, node=spawn_on)
                            else:
                                target = (
                                    spawn_wanted_actors
                                    if spec.task_type
                                    == TaskType.ACTOR_CREATION_TASK
                                    else spawn_wanted
                                )
                                target[spawn_on.node_id] = (
                                    target.get(spawn_on.node_id, 0) + 1
                                )
                        continue
                    node, ws = chosen
                    self._acquire(node, demand)
                node, ws = chosen
                self._cache_remove_idle(cache, ws)
                ws.assigned = dict(demand)
                ws.assigned_pg = pg_grant
                task_hex = spec.task_id.hex()
                self.running[task_hex] = (ws.worker_id, pt)
                if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                    ws.state = ACTOR
                    ws.actor_hex = spec.actor_id.hex()
                else:
                    ws.state = BUSY
                    ws.current_task = task_hex
                asyncio.ensure_future(self._dispatch(node, ws, pt))
                self._maybe_prefetch(ws, node, pt, cache)
                made_progress = True
        # One pass over the worker table serves every spawn decision below
        # (per-call scans dominated profiles at 58k _spawn_worker calls).
        # In-flight boots are tracked by node.spawning / the spawn ledger —
        # registered workers are never in STARTING state, so only the live
        # count needs the table walk.
        live_by_node: Dict[str, int] = {}
        if spawn_wanted or spawn_wanted_actors or self.ready_queue:
            for w in self.workers.values():
                if w.state in (DEAD, ACTOR):
                    continue  # task-pool occupancy only (see _spawn_worker)
                live_by_node[w.node_id] = live_by_node.get(w.node_id, 0) + 1
        # Flush per-node spawn demand, net of workers already booting there
        # (reference analog: worker_pool PrestartWorkers on backlog hints,
        # `worker_pool.h:354` — backlog-sized, not one-per-event).
        for forced, wants in ((False, spawn_wanted), (True, spawn_wanted_actors)):
            for node_id, wanted in wants.items():
                node = self.nodes.get(node_id)
                if node is None or not node.alive:
                    continue
                booting = node.spawning
                for _ in range(
                    max(0, min(wanted - booting, rt_config.get("spawn_burst_cap")))
                ):
                    # node.spawning increments per spawn — in-loop spawns are
                    # already counted; adding i here double-counted them.
                    self._spawn_worker(
                        node=node,
                        live_count=live_by_node.get(node_id, 0),
                        force=forced,
                    )
        # Top the head pool up to the queue depth.
        starting = self.head.spawning
        # Exact CPU-backlog count is O(queue); bound the scan to the first
        # 256 entries — an UNDERestimate for deeper queues (spawning catches
        # up as the queue drains), and still exactly 0 for TPU-only queues
        # (counting those as CPU would ratchet useless head workers up to
        # the pool cap).
        cpu_backlog = sum(
            1 for pt in itertools.islice(self.ready_queue, 256)
            if pt.spec.resources.get(ACCELERATOR, 0) == 0  # reference: "TPU", ray_tpu/core/controller.py:3192
            # Actor creations get FORCED dedicated spawns above — counting
            # them here pre-forks pool workers nothing will ever run on
            # (observed: ~30 junk forks per 100-actor burst).
            and pt.spec.task_type != TaskType.ACTOR_CREATION_TASK
        )
        deficit = cpu_backlog - starting
        head_live = live_by_node.get(self.head.node_id, 0)
        for _ in range(max(0, min(deficit, rt_config.get("worker_prestart_cap")))):
            self._spawn_worker(live_count=head_live)
        self._reclaim_stranded_prefetches()
        self._revoke_leases_for_backlog()

    def _reclaim_stranded_prefetches(self):
        """Un-strand prefetched tasks: a task pipelined behind a busy worker
        (_maybe_prefetch) waits on that worker's current task — if a worker
        that could actually RUN it has since gone idle, ask the busy worker
        to give the un-started spec back. The protocol is event-driven (no
        timeouts, no ambiguity): the reclaim is a one-way push; the worker
        answers with its own `task_dropped` push only if the drop beat
        execution (h_task_dropped requeues), else its `task_done` arrives as
        usual and the reclaim dissolves."""
        if not self._prefetch_ids:
            return
        pending = []
        for wid in list(self._prefetch_ids):
            ws = self.workers.get(wid)
            if ws is None or ws.prefetch_task is None:
                self._prefetch_ids.discard(wid)  # self-cleaning
                continue
            if ws.reclaiming_task is None and ws.conn is not None:
                pending.append(ws)
        if not pending:
            return
        idle = [
            w for w in self.workers.values()
            if w.state == IDLE and w.conn is not None
        ]
        if not idle:
            return
        for ws in pending:
            if not idle:
                break
            entry = self.running.get(ws.prefetch_task)
            if entry is None:
                continue
            demand = entry[1].spec.resources
            need_tpu = demand.get(ACCELERATOR, 0) > 0  # reference: "TPU", ray_tpu/core/controller.py:3239
            # Reclaiming only helps if some idle worker can take the task NOW
            # (TPU-capability match + node capacity) — otherwise the task
            # would lose its guaranteed next-in-line slot for nothing. Each
            # matched idle worker is consumed so at most idle-capacity-many
            # prefetches are pulled back per pass.
            match = next(
                (
                    w for w in idle
                    if (w.has_tpu or not need_tpu)
                    and w.node_id in self.nodes
                    and self._fits_node(self.nodes[w.node_id], demand)
                ),
                None,
            )
            if match is None:
                continue
            idle.remove(match)
            ws.reclaiming_task = ws.prefetch_task
            asyncio.ensure_future(self._send_reclaim(ws, ws.prefetch_task))

    async def _send_reclaim(self, ws: WorkerState, task_hex: str):
        try:
            await ws.conn.send({"type": "reclaim_task", "task": task_hex})
        except Exception:  # noqa: BLE001 — worker dying; death path requeues
            ws.reclaiming_task = None

    async def h_task_dropped(self, conn, meta, msg):
        """The worker dropped a reclaimed prefetch before executing it.
        Worker→controller FIFO means any task_done(current) sorted before
        this, so exactly two worker states are possible: the task is still
        prefetch-pending, or it was promoted to current (in which case the
        worker is actually idle — it skipped the spec)."""
        task_hex = msg["task"]
        ws = self.workers.get(meta["worker_id"]) if meta.get("worker_id") else None
        if ws is not None:
            if ws.reclaiming_task == task_hex:
                ws.reclaiming_task = None
            if ws.prefetch_task == task_hex:
                ws.prefetch_task = None
            elif ws.current_task == task_hex and ws.state == BUSY:
                ws.state = IDLE
                ws.current_task = None
                self._grant_release(ws)
        entry = self.running.pop(task_hex, None)
        if entry is None:
            return None
        if task_hex in self.cancelled:
            self._finish_cancelled(entry[1])
        else:
            self.ready_queue.appendleft(entry[1])  # it was the FIFO head
            self._event(
                "task_reclaimed", task=task_hex,
                worker=ws.worker_id if ws is not None else "",
            )
        self._schedule()
        return None

    # ------------------------------------------------- direct task plane
    # Reference analog: `direct_task_transport.cc:135-247` — submitters hold
    # cached worker leases and push task specs straight to the leased worker
    # (PushNormalTask), touching the scheduler only for grant/return. Here
    # the controller additionally stays out of the RESULT path: small
    # results return inline over the submitter↔worker socket.
    async def h_request_lease(self, conn, meta, msg):
        demand = {k: float(v) for k, v in (msg.get("resources") or {}).items()}
        need_tpu = demand.get(ACCELERATOR, 0) > 0  # reference: "TPU", ray_tpu/core/controller.py:3305
        count = max(1, min(int(msg.get("count", 1)), 16))
        # Autoscaler demand is the submitter's waiting tasks, not the leases
        # it asks for ahead of them (reference: `count` for both,
        # ray_tpu/core/controller.py:3327,3335).
        unmet = min(count, max(0, int(msg.get("backlog", count))))
        # PARK until at least one grant or the deadline: a cold pool takes a
        # spawn round (~0.5s) to produce grantable workers — client-side
        # retry backoff turned that into multi-second task latency.
        deadline = time.monotonic() + min(float(msg.get("wait_s", 8.0)), 30.0)
        bkey = tuple(sorted(demand.items()))
        first = True
        # LocalDispatchers lease only their OWN node's workers (the point of
        # the handoff is node-local dispatch); submitters lease anywhere.
        node_filter = msg.get("node_id")
        # A node that joins while the request parks (the autoscaler's
        # scale-up) gets its spawn now, not after the deadline's re-request
        # (reference: spawn=first only, ray_tpu/core/controller.py:3318).
        # (A re-registered node id is a new NodeState: compare the records;
        # `seen` holds them, so their ids are not reused meanwhile.)
        seen = list(self.nodes.values())
        while True:
            seen_ids = {id(n) for n in seen}
            joined = any(id(n) not in seen_ids for n in self.nodes.values())
            grants = self._try_grant_leases(
                meta, demand, need_tpu, count, spawn=first or joined,  # reference: spawn=first
                node_filter=node_filter,
            )
            first = False
            seen = list(self.nodes.values())
            if grants or time.monotonic() >= deadline:
                break
            # The PARKED demand is autoscaler load — record it now, not
            # after the park (scale-up is what un-parks a full cluster).
            self._lease_backlog[bkey] = (demand, unmet, time.monotonic())  # reference: count
            try:
                await asyncio.wait_for(self._worker_arrival.wait(), 0.25)
            except (asyncio.TimeoutError, TimeoutError):
                pass
        # Feed the autoscaler load metrics (drivers re-request while
        # buffered, refreshing the entry; satisfied requests clear it).
        if len(grants) < unmet:  # reference: count
            self._lease_backlog[bkey] = (demand, unmet - len(grants), time.monotonic())
        else:
            self._lease_backlog.pop(bkey, None)
        if grants:
            self._wal_append(
                "lease_granted",
                workers=[g["worker_id"] for g in grants],
                holder=meta.get("conn_id") or 0,
            )
            self._event("lease_granted", n=len(grants), holder=meta.get("conn_id"))
        return {"leases": grants}

    def _try_grant_leases(self, meta, demand, need_tpu, count, spawn=True,
                          node_filter=None):
        grants = []
        spawn_hint: Optional[NodeState] = None
        # One idle-worker index per grant call: the uncached scan was
        # O(workers) per requested lease — a wave of 5k resident actor
        # workers made every lease request pay a full table walk.
        cache: Dict[str, Any] = {}
        for _ in range(count):
            got = None
            for node in self.nodes.values():
                if node_filter is not None and node.node_id != node_filter:
                    continue
                if not self._fits_node(node, demand):
                    continue
                ws = self._idle_worker(node.node_id, need_tpu, cache)
                if ws is None:
                    spawn_hint = spawn_hint or node
                    continue
                if not ws.direct_addr:
                    continue
                got = (node, ws)
                break
            if got is None:
                break
            node, ws = got
            self._acquire(node, demand)
            ws.assigned = dict(demand)
            ws.state = LEASED
            self._leased_ids.add(ws.worker_id)
            ws.leased_to = meta.get("conn_id")
            meta.setdefault("leases", set()).add(ws.worker_id)
            grants.append({"worker_id": ws.worker_id, "addr": ws.direct_addr})
        if spawn and len(grants) < count and spawn_hint is not None and not need_tpu:
            # Under-supplied: top the pool up, NET of workers already
            # booting (unbounded bursts per grow probe were a spawn storm —
            # each booting interpreter costs ~2s of CPU).
            want = count - len(grants) - spawn_hint.spawning
            for _ in range(
                max(0, min(want, rt_config.get("spawn_burst_cap")))
            ):
                self._spawn_worker(node=spawn_hint)
        if spawn and len(grants) < count and spawn_hint is not None and need_tpu:
            # A GPU task's lease boots its cold GPU worker now; without this
            # the lease parks to its deadline and the task waits ~30 s for
            # the classic path's spawn. (reference: no spawn for a TPU
            # lease, ray_tpu/core/controller.py:3379)
            self._spawn_worker(tpu=True, node=spawn_hint)
        return grants

    def _release_lease(self, ws: WorkerState, requeue: bool = True):
        if ws.state != LEASED:
            return
        self._leased_ids.discard(ws.worker_id)
        if ws.blocked:
            # Capacity already released at block time (h_worker_blocked) —
            # releasing again would double-credit the node.
            ws.assigned = {}
            ws.assigned_pg = None
            ws.blocked = False
        else:
            self._grant_release(ws)
        ws.state = IDLE
        ws.leased_to = None
        ws.revoking = False
        if requeue:
            self._schedule()

    async def h_return_lease(self, conn, meta, msg):
        self._return_one_lease(meta, msg["worker_id"])
        return {"ok": True}

    async def h_return_lease_batch(self, conn, meta, msg):
        """Batched give-back from a holder's idle sweep — one frame, one
        scheduling request for the whole set."""
        for worker_id in msg.get("worker_ids", ()):
            self._return_one_lease(meta, worker_id)
        return None

    def _return_one_lease(self, meta, worker_id: str):
        ws = self.workers.get(worker_id)
        leases = meta.get("leases")
        if leases is not None:
            leases.discard(worker_id)
        if ws is not None and ws.leased_to == meta.get("conn_id"):
            self._wal_append("lease_returned", worker=worker_id)
            self._release_lease(ws)

    def _revoke_leases_for_backlog(self):
        """Queued work + zero placement → pull leases back (the holder
        drains in-flight pushes and returns). Prevents idle-leased workers
        from starving the queued path."""
        if not self.ready_queue or not self._leased_ids:
            return
        for wid in list(self._leased_ids):
            ws = self.workers.get(wid)
            if ws is None or ws.state != LEASED or ws.revoking or ws.leased_to is None:
                continue
            holder = self._conns_by_id.get(ws.leased_to)
            if holder is None:
                self._release_lease(ws)
                continue
            ws.revoking = True
            asyncio.ensure_future(self._send_revoke(holder, ws))

    async def _send_revoke(self, holder: Connection, ws: WorkerState):
        try:
            await holder.send({"type": "revoke_lease", "worker_id": ws.worker_id})
        except Exception:  # noqa: BLE001 — holder dying; disconnect cleans up
            pass

    # -------------------------------------------- direct actor call plane
    # Reference analog: direct actor call transport — after creation, actor
    # calls flow submitter→actor-worker without the GCS/raylet in the loop.
    # The handoff FENCE threads through the same controller→worker FIFO as
    # queued classic calls, so direct mode starts only after every prior
    # classic call is already in the worker's queue (ordering preserved).
    async def h_actor_handoff(self, conn, meta, msg):
        astate = self.actors.get(msg["actor"])
        if astate is None or astate.state == "dead":
            return {"ok": False, "reason": "actor not alive"}
        token = f"{msg['actor']}:{next(self._handoff_counter)}"
        fut = asyncio.get_running_loop().create_future()
        self._handoff_waiters[token] = fut
        # The fence rides the actor's ORDERED send queue (_pump_actor), so
        # every classic call submitted before it — including calls still
        # waiting on args or on actor creation — reaches the worker first.
        self._shard_enqueue(astate, _HandoffFence(token))
        try:
            await asyncio.wait_for(fut, timeout=msg.get("timeout", 30))
        except Exception:  # noqa: BLE001 — worker busy/dead; caller stays classic
            return {"ok": False, "reason": "handoff timed out"}
        finally:
            self._handoff_waiters.pop(token, None)
        ws = self.workers.get(astate.worker_id)
        if astate.state != "alive" or ws is None or not ws.direct_addr:
            return {"ok": False, "reason": "actor not alive"}
        return {"ok": True, "addr": ws.direct_addr, "worker_id": ws.worker_id}

    async def h_handoff_ready(self, conn, meta, msg):
        fut = self._handoff_waiters.get(msg["token"])
        if fut is not None and not fut.done():
            fut.set_result(True)
        return None

    def _resolve_handoff_failed(self, token: str):
        """Main-loop: answer a handoff waiter whose fence met a dead actor
        (h_actor_handoff re-checks liveness after the future resolves, so a
        False here yields its not-alive reply)."""
        fut = self._handoff_waiters.get(token)
        if fut is not None and not fut.done():
            fut.set_result(False)

    def _maybe_prefetch(
        self,
        ws: WorkerState,
        node: NodeState,
        pt: PendingTask,
        cache: Optional[dict] = None,
    ):
        """Queue ONE more same-shape task behind the one just dispatched
        (reference: lease reuse — steady-state same-shape submission skips
        the raylet, `direct_task_transport.cc:135-247`). Only argless,
        non-streaming, non-PG NORMAL tasks at the queue head qualify: no dep
        materialization, no bundle accounting, FIFO preserved."""
        spec = pt.spec
        if (
            ws.state != BUSY
            or ws.prefetch_task is not None
            or not self.ready_queue
            or spec.task_type != TaskType.NORMAL_TASK
            or spec.num_returns == -1
            or spec.arg_refs
            or ws.assigned_pg is not None
        ):
            return
        sig = pt.sched_sig(spec.resources.get(ACCELERATOR, 0) > 0)  # reference: "TPU", ray_tpu/core/controller.py:3516
        if sig is None:  # spread: placement differs per decision — no reuse
            return
        # Only pipeline when no idle worker is left to take the head task
        # directly — otherwise prefetching steals work from idle capacity
        # and SERIALIZES a small fan-out.
        idle_idx = cache.get("idle") if cache is not None else None
        if idle_idx is None or any(
            lst for kind in idle_idx.values() for lst in kind.values()
        ):
            return
        head = self.ready_queue[0]
        hspec = head.spec
        if (
            hspec.task_type != TaskType.NORMAL_TASK
            or hspec.num_returns == -1
            or hspec.arg_refs
            or hspec.task_id.hex() in self.cancelled
            or head.sched_sig(hspec.resources.get(ACCELERATOR, 0) > 0) != sig  # reference: "TPU", ray_tpu/core/controller.py:3534
            or _task_env_key(hspec) != _task_env_key(spec)
        ):
            return
        self.ready_queue.popleft()
        task_hex = hspec.task_id.hex()
        self.running[task_hex] = (ws.worker_id, head)
        ws.prefetch_task = task_hex
        self._prefetch_ids.add(ws.worker_id)
        asyncio.ensure_future(self._dispatch_prefetch(ws, head))

    async def _dispatch_prefetch(self, ws: WorkerState, pt: PendingTask):
        spec = pt.spec
        try:
            ws.conn.post(
                {
                    "type": "execute_task",
                    "spec": spec_to_proto_bytes(spec),
                    "deps": {},
                }
            )
        except Exception:  # noqa: BLE001 — send failed: worker is dying;
            # _on_worker_death will retry the task via self.running.
            pass

    def _finish_cancelled(self, pt: PendingTask):
        self._fail_task(pt, TaskError(TaskCancelledError(), "", pt.spec.name))

    def _fail_stream(self, spec: TaskSpec, err: TaskError):
        """Terminal failure of a streaming task: one error item, then end —
        a waiting consumer must never hang."""
        self._fail_stream_hex(spec.task_id.hex(), err)

    def _fail_stream_hex(self, task_hex: str, err: TaskError):
        from .ids import TaskID

        s = self._stream(task_hex)
        if s["done"]:
            return
        idx = s["produced"]
        oid_hex = ObjectID.of(TaskID.from_hex(task_hex), idx).hex()
        self._obj(oid_hex).expected = True
        self._store_error_object(oid_hex, err)
        s["produced"] = idx + 1
        s["done"] = True
        self._wake_stream(s)

    def _fail_streams_of_actor(self, actor_hex: str, err: TaskError):
        """End every open stream owned by a dead actor's tasks. Streaming
        calls delivered over the DIRECT actor channel never pass through
        this controller as specs — a call still queued in the dead worker
        leaves only a stream entry (created lazily by the consumer's
        stream_next long-poll), and nothing else will ever end it. TaskID
        encodes the actor id, so the sweep needs no spec."""
        from .ids import TaskID

        for task_hex, s in list(self.streams.items()):
            if s["done"]:
                continue
            try:
                owner = TaskID.from_hex(task_hex).actor_id().hex()
            except Exception:  # noqa: BLE001 — malformed/foreign id
                continue
            if owner == actor_hex:
                self._fail_stream_hex(task_hex, err)

    def _fail_task(self, pt: PendingTask, err: TaskError):
        """Terminal failure for a not-yet-dispatched task: unpin args, error
        the returns, and mark a would-be actor dead."""
        spec = pt.spec
        self._unpin_args(spec)
        if spec.num_returns == -1:
            self._fail_stream(spec, err)
        if spec.task_type == TaskType.ACTOR_CREATION_TASK and spec.actor_id:
            astate = self.actors.get(spec.actor_id.hex())
            if astate is not None:
                astate.init_error = err
                self._set_actor_state(astate, "dead")
                self._drain_actor_queue(astate, err)
        for oid in spec.return_ids:
            self._store_error_object(oid.hex(), err)

    async def h_task_events(self, conn, meta, msg):
        """Batched timeline events from a worker's direct-path executions
        (reference analog: profile-event batch flushes) — keeps tracing,
        `api.timeline()`, and the running-task view complete without
        per-task control traffic."""
        events = msg.get("events", ())
        self.timeline.extend(events)
        self._trim_timeline()
        names: Dict[str, str] = {}
        for ev in events:
            kind = ev.get("event")
            task = ev.get("task")
            if kind == "task_submitted":
                names[task] = ev.get("name", "")
            elif kind == "task_dispatched":
                if len(self.direct_running) < 10_000:
                    self.direct_running[task] = {
                        "name": names.get(task, ""),
                        "worker_id": ev.get("worker", ""),
                    }
            elif kind == "task_done":
                self.direct_running.pop(task, None)
            elif kind == "task_span":
                # Consolidated per-task event (burst fast path): the task is
                # already done — only the early RUNNING pair ever inserted it.
                if ev.get("early"):
                    self.direct_running.pop(task, None)
        return None

    async def h_task_done(self, conn, meta, msg):
        task_hex = msg["task"]
        if msg.get("direct"):
            # Direct-path task on a LEASED worker: the controller's only job
            # is the object directory (results too big / ref-carrying to ride
            # the submitter socket inline) — no scheduler state to touch.
            node_id = (
                self.workers[meta["worker_id"]].node_id
                if meta.get("worker_id") in self.workers
                else HEAD_NODE
            )
            for item in msg["results"]:
                if item.get("inline") is not None:
                    self._mark_ready(
                        item["id"], inline=item["inline"],
                        size=len(item["inline"]), contains=item.get("contains"),
                    )
                else:
                    self._mark_ready(
                        item["id"], shm_name=item["name"], size=item["size"],
                        node_id=node_id, contains=item.get("contains"),
                    )
            if msg.get("stream_count") is not None:
                s = self._stream(task_hex)
                s["produced"] = max(s["produced"], msg["stream_count"])
                s["done"] = True
                self._wake_stream(s)
            if msg.get("spec") is not None:
                # Registered (arena-resident) results are reconstructible —
                # remember the creating spec like any scheduled task.
                self._remember_lineage(spec_from_proto_bytes(msg["spec"]))
            return None
        entry = self.running.pop(task_hex, None)
        if entry is not None:
            self._unpin_args(entry[1].spec)
            if entry[0].startswith("@"):  # agent-dispatched (handoff plane)
                hnode = self.nodes.get(entry[0][1:])
                if hnode is not None:
                    hnode.handoff_inflight = max(0, hnode.handoff_inflight - 1)
        ws = self.workers.get(meta["worker_id"]) if meta["worker_id"] else None
        node_id = ws.node_id if ws is not None else HEAD_NODE
        if ws is not None and ws.reclaiming_task == task_hex:
            ws.reclaiming_task = None  # reclaim lost the race — task executed
        if ws is not None and ws.state == BUSY:
            if ws.current_task == task_hex and ws.prefetch_task is not None:
                # Lease reuse: the next task is already queued on the worker —
                # keep the grant, promote, skip the idle→dispatch round trip.
                ws.current_task = ws.prefetch_task
                ws.prefetch_task = None
            else:
                ws.state = IDLE
                ws.current_task = None
                ws.prefetch_task = None
                self._grant_release(ws)
        if ws is not None and ws.actor_hex:
            astate = self.actors.get(ws.actor_hex)
            if astate is not None:
                with astate.lock:  # pump (shard loop) writes concurrently
                    ispec = astate.inflight.pop(task_hex, None)
                if ispec is not None:
                    self._unpin_args(ispec)
        for item in msg["results"]:
            if item.get("inline") is not None:
                self._mark_ready(
                    item["id"], inline=item["inline"], size=len(item["inline"]),
                    contains=item.get("contains"),
                )
            else:
                self._mark_ready(
                    item["id"], shm_name=item["name"], size=item["size"],
                    node_id=node_id, contains=item.get("contains"),
                )
        if msg.get("stream_count") is not None:
            s = self._stream(task_hex)
            s["produced"] = max(s["produced"], msg["stream_count"])
            s["done"] = True
            self._wake_stream(s)
        self._event("task_done", task=task_hex)
        self._schedule()
        return None

    async def h_actor_ready(self, conn, meta, msg):
        actor_hex = msg["actor"]
        astate = self.actors.get(actor_hex)
        task_hex = msg.get("task")
        if task_hex:
            entry = self.running.pop(task_hex, None)
            if entry is not None:
                self._unpin_args(entry[1].spec)
        if astate is None:
            return None
        if msg.get("error") is not None:
            err = serialization.unpack(msg["error"])
            astate.init_error = err
            self._set_actor_state(astate, "dead")
            self._drain_actor_queue(astate, err)
            return None
        ws = self.workers.get(meta["worker_id"])
        if ws is not None:
            astate.worker_id = ws.worker_id
        self._set_actor_state(astate, "alive")
        self._wal_append("actor_alive", actor=actor_hex,
                         worker=astate.worker_id or "")
        self._event("actor_alive", actor=actor_hex)
        return None

    def _set_actor_state(self, astate: ActorState, state: str):
        astate.state = state
        astate.wake()  # pump waits on the SHARD loop — marshal the set

    def _drain_actor_queue(self, astate: ActorState, err: TaskError):
        """Fail every queued (undelivered) call. The send queue is owned by
        the actor's shard loop — pop there, then store the error returns on
        the main loop (object directory). Calls racing this drain land on
        the shard loop in marshal order, so they are either drained here or
        see state == dead in the pump."""

        def drain():
            specs = []
            while astate.send_queue:
                spec = astate.send_queue.popleft()
                if isinstance(spec, _HandoffFence):
                    # Fail the waiter promptly; caller stays classic.
                    self._main_call_soon(
                        self._resolve_handoff_failed, spec.token
                    )
                    continue
                specs.append(spec)
            if not specs:
                return

            def store():
                for spec in specs:
                    self._unpin_args(spec)
                    if spec.num_returns == -1:
                        # Queued streaming call: end its stream with the
                        # error so the consumer's generator raises instead
                        # of long-polling forever.
                        self._fail_stream(spec, err)
                    for oid in spec.return_ids:
                        self._store_error_object(oid.hex(), err)

            self._main_call_soon(store)

        sh = astate.shard
        if sh is not None and sh.loop is not None:
            try:
                sh.loop.call_soon_threadsafe(drain)
                return
            except RuntimeError:
                pass
        drain()

    # -------------------------------------------------------------- actors
    def _register_actor(self, msg: dict) -> dict:
        """Register one actor creation (shared by the single and batched
        frames): directory entry in its shard, name claim through the
        coordination layer, creation task enqueued. One _schedule per
        BATCH happens at the caller (deferred coalescing absorbs it)."""
        spec: TaskSpec = spec_from_proto_bytes(msg["spec"])
        actor_hex = spec.actor_id.hex()
        # Dedup key: the client-minted actor id. A creation frame
        # resubmitted after a head failover (reconnect ledger) — or one
        # whose WAL record already replayed — must not register twice.
        if actor_hex in self.actors:
            return {"ok": True, "dup": True}
        bad = self._infeasible(spec.resources)
        if bad:
            astate = ActorState(actor_hex=actor_hex, spec=None, state="dead")
            err_text = (
                f"Actor {spec.name} demands {bad} but no node can fit it "
                f"(cluster total {self._cluster_totals()}) — infeasible."
            )
            astate.init_error = TaskError(RuntimeError(err_text), "", spec.name)
            self.actors[actor_hex] = astate
            astate.shard = self.actors.shard_for(actor_hex)
            self._wal_append("actor_infeasible", actor=actor_hex, error=err_text)
            return {"ok": False}
        astate = ActorState(
            actor_hex=actor_hex,
            spec=spec,
            name=msg.get("name", ""),
            namespace=msg.get("namespace", "default"),
            handle_bytes=msg.get("handle", b""),
            detached=spec.options.lifetime == "detached",
        )
        if astate.name:
            key = (astate.namespace, astate.name)
            if key in self.named_actors:
                return {"error": f"Actor name '{astate.name}' already taken"}
            self.named_actors[key] = actor_hex
        self.actors[actor_hex] = astate
        astate.shard = self.actors.shard_for(actor_hex)
        # WAL before ack (write-ahead contract): the registration + name
        # bind must be durable before any client can observe them.
        self._wal_append(
            "actor_registered",
            actor=actor_hex,
            spec=msg["spec"],
            name=astate.name,
            namespace=astate.namespace,
            handle=msg.get("handle", b""),
            detached=astate.detached,
        )
        self._pin_args(spec)
        pt = PendingTask(spec=spec, retries_left=0)
        self._event("actor_created", actor=actor_hex, name=astate.name)
        self._enqueue(pt)
        return {"ok": True}

    async def h_create_actor(self, conn, meta, msg):
        out = self._register_actor(msg)
        self._schedule()
        return out

    async def h_create_actor_batch(self, conn, meta, msg):
        """Coalesced creation frames from one client (cluster_backend
        batches anonymous creations): N directory registrations, ONE
        scheduling request — a 2,000-actor wave is a handful of passes
        instead of 2,000 (reference analog: the GCS's batched actor
        registration RPCs feeding one scheduling round)."""
        for item in msg["items"]:
            self._register_actor(item)
        self._schedule()
        return None

    async def _send_actor_task(self, astate: ActorState, spec: TaskSpec):
        def fail(err: TaskError):
            with astate.lock:
                astate.inflight.pop(spec.task_id.hex(), None)
            self._unpin_args(spec)
            for oid in spec.return_ids:
                self._store_error_object(oid.hex(), err)

        ws = self.workers.get(astate.worker_id)
        if ws is None or ws.conn is None or ws.state == DEAD:
            fail(TaskError(ActorDiedError(), "", spec.name))
            return
        try:
            await asyncio.gather(
                *(self._ensure_local(ws.node_id, oid.hex()) for oid in spec.arg_refs)
            )
        except Exception as e:  # noqa: BLE001
            fail(TaskError(RuntimeError(f"dependency transfer failed: {e}"), "", spec.name))
            return
        try:
            ws.conn.post(
                {
                    "type": "execute_actor_task",
                    "spec": spec_to_proto_bytes(spec),
                    "deps": self._deps_payload_safe(spec, ws.node_id),
                }
            )
        except ConnectionError:
            fail(TaskError(ActorDiedError(), "", spec.name))

    def _deps_payload_safe(self, spec: TaskSpec, node_id: str) -> dict:
        locs = {}
        for oid in spec.arg_refs:
            h = oid.hex()
            obj = self.objects.get(h)
            locs[h] = (
                self._location_payload(obj, node_id)
                if obj and obj.status == "ready"
                else {"status": "pending"}
            )
        return locs

    async def h_submit_actor_task(self, conn, meta, msg):
        spec: TaskSpec = spec_from_proto_bytes(msg["spec"])
        actor_hex = spec.actor_id.hex()
        astate = self.actors.get(actor_hex)
        if astate is None or astate.state == "dead":
            err = astate.init_error if astate else None
            err = err or TaskError(ActorDiedError(), "", spec.name)
            if spec.num_returns == -1:
                # Streaming call to a dead actor: return_ids is EMPTY — only
                # ending the stream itself stops the consumer's long-poll
                # (observed: next() waiting out the full stream timeout).
                self._fail_stream(spec, err)
            for oid in spec.return_ids:
                self._store_error_object(oid.hex(), err)
            return {"ok": False}
        self._pin_args(spec)
        self._expect_returns(spec)
        self._shard_enqueue(astate, spec)
        return {"ok": True}

    # -------------------------------------------- shard delivery plane
    # The actor send queue + pump live on the actor's SHARD loop
    # (control_shards.py): the main loop marshals appends/drains there and
    # the pump marshals object-directory work back. FIFO order per
    # submitting thread is preserved by call_soon_threadsafe.
    def _main_call_soon(self, fn, *args):
        """Run fn on the main (scheduler/object-directory) loop; inline when
        already there — shard-loop callers get a deferred, ordered call."""
        loop = getattr(self, "_main_loop", None)
        if loop is None:
            fn(*args)
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            fn(*args)
            return
        try:
            loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:
            pass  # main loop closed (shutdown)

    async def _run_on_main(self, coro):
        """Await a coroutine on the main loop from a shard loop (ordered
        delivery steps that need scheduler/object state)."""
        loop = asyncio.get_running_loop()
        main = getattr(self, "_main_loop", None)
        if main is None or loop is main:
            return await coro
        return await asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(coro, main)
        )

    def _shard_enqueue(self, astate: ActorState, item):
        """Append to the actor's ordered send queue and ensure its pump
        runs — both on the owning shard's loop (single-writer)."""

        def run():
            astate.send_queue.append(item)
            if not astate.pump_active:
                astate.pump_active = True
                asyncio.get_running_loop().create_task(self._pump_actor(astate))

        sh = astate.shard
        if sh is not None and sh.loop is not None:
            try:
                sh.loop.call_soon_threadsafe(run)
                return
            except RuntimeError:
                pass  # shard loop stopped (shutdown) — fall through
        # No shard loop (unit tests poking controller state directly).
        astate.send_queue.append(item)
        if not astate.pump_active:
            astate.pump_active = True
            asyncio.ensure_future(self._pump_actor(astate))

    async def _shard_wait_ready(self, hex_id: str):
        """Shard-side wait for an object's readiness. Registration happens
        ON the main loop (the object directory's owner — a racy check-then
        -append from this thread could miss the wake between _mark_ready's
        event sweep and clear)."""
        loop = asyncio.get_running_loop()
        main = getattr(self, "_main_loop", None)
        if main is None or loop is main:
            obj = self._obj(hex_id)
            while obj.status != "ready":
                ev = asyncio.Event()
                obj.events.append(ev)
                await ev.wait()
            return
        from .control_shards import CrossLoopEvent

        while True:
            sev = asyncio.Event()

            def reg():
                obj = self._obj(hex_id)
                if obj.status == "ready":
                    try:
                        loop.call_soon_threadsafe(sev.set)
                    except RuntimeError:
                        pass
                else:
                    obj.events.append(CrossLoopEvent(loop, sev))

            self._main_call_soon(reg)
            await sev.wait()
            obj = self.objects.get(hex_id)
            if obj is not None and obj.status == "ready":
                return

    def _fail_actor_call(self, spec: TaskSpec, err: Optional[TaskError]):
        """Store error returns for an undeliverable actor call — on the
        main loop (object directory owner); callable from shard loops."""
        err = err or TaskError(ActorDiedError(), "", spec.name)

        def run():
            self._unpin_args(spec)
            if spec.num_returns == -1:
                self._fail_stream(spec, err)
            for oid in spec.return_ids:
                self._store_error_object(oid.hex(), err)

        self._main_call_soon(run)

    async def _pump_actor(self, astate: ActorState):
        """Deliver this actor's calls strictly in submission order — runs on
        the actor's SHARD loop. Argless calls to a live actor (the
        steady-state hot path) are delivered entirely shard-side via the
        thread-safe conn.post; calls needing the object directory
        (arg deps, error returns) marshal through the main loop."""
        try:
            while astate.send_queue:
                spec = astate.send_queue[0]
                for oid in spec.arg_refs:
                    await self._shard_wait_ready(oid.hex())
                while astate.state in ("pending", "restarting"):
                    astate.state_event.clear()
                    await astate.state_event.wait()
                if not astate.send_queue or astate.send_queue[0] is not spec:
                    continue  # queue drained by a death path while we waited
                astate.send_queue.popleft()
                if isinstance(spec, _HandoffFence):
                    ws = self.workers.get(astate.worker_id)
                    if astate.state == "alive" and ws is not None and ws.conn is not None:
                        try:
                            ws.conn.post(
                                {"type": "actor_handoff", "token": spec.token}
                            )
                        except Exception:  # noqa: BLE001 — waiter times out
                            pass
                    else:
                        # Dead/unreachable: answer the handoff waiter NOW —
                        # the caller falls back to classic (and its buffered
                        # calls fail fast) instead of waiting out the 30s
                        # handoff timeout against a dead actor.
                        self._main_call_soon(
                            self._resolve_handoff_failed, spec.token
                        )
                    continue
                if astate.state == "dead":
                    self._fail_actor_call(spec, astate.init_error)
                    continue
                task_hex = spec.task_id.hex()
                with astate.lock:
                    astate.inflight[task_hex] = spec
                if not spec.arg_refs:
                    ws = self.workers.get(astate.worker_id)
                    if ws is None or ws.conn is None or ws.state == DEAD:
                        with astate.lock:
                            astate.inflight.pop(task_hex, None)
                        self._fail_actor_call(
                            spec, TaskError(ActorDiedError(), "", spec.name)
                        )
                        continue
                    try:
                        ws.conn.post(
                            {
                                "type": "execute_actor_task",
                                "spec": spec_to_proto_bytes(spec),
                                "deps": {},
                            }
                        )
                    except ConnectionError:
                        with astate.lock:
                            astate.inflight.pop(task_hex, None)
                        self._fail_actor_call(
                            spec, TaskError(ActorDiedError(), "", spec.name)
                        )
                    continue
                await self._run_on_main(self._send_actor_task(astate, spec))
        finally:
            if astate.send_queue and not self._shutdown_event.is_set():
                # A racer appended between our last check and this exit
                # (same loop, so this check-and-restart is atomic). The
                # shutdown guard keeps a closing main loop from turning a
                # failing pump into a restart spin.
                asyncio.get_running_loop().create_task(self._pump_actor(astate))
            else:
                astate.pump_active = False

    async def h_kill_actor(self, conn, meta, msg):
        actor_hex = msg["actor"]
        no_restart = msg.get("no_restart", True)
        astate = self.actors.get(actor_hex)
        if astate is None:
            return {"ok": False}
        self._set_actor_state(astate, "dead")
        if no_restart:
            astate.spec = None
        self._wal_append("actor_killed", actor=actor_hex, no_restart=no_restart)
        err = TaskError(ActorDiedError("Actor was killed."), "", "actor task")
        self._drain_actor_queue(astate, err)
        # Inflight (already-delivered) calls can never complete either — the
        # worker is being terminated. Fail them NOW: a delivered streaming
        # call otherwise leaves its consumer long-polling out the full
        # stream timeout (observed: 300s for a one-line test). Results that
        # raced ahead and completed are left alone (ready check below).
        with astate.lock:  # pump (shard loop) writes concurrently
            inflight = list(astate.inflight.values())
            astate.inflight.clear()
        for ispec in inflight:
            self._unpin_args(ispec)
            if ispec.num_returns == -1:
                self._fail_stream(ispec, err)
            for oid in ispec.return_ids:
                if self._obj(oid.hex()).status != "ready":
                    self._store_error_object(oid.hex(), err)
        for key, ah in list(self.named_actors.items()):
            if ah == actor_hex:
                del self.named_actors[key]
        # Streams of direct-plane calls queued in the dying worker have no
        # controller-side spec to drain — end them by owner id.
        self._fail_streams_of_actor(actor_hex, err)
        ws = self.workers.get(astate.worker_id)
        if ws is not None:
            self._terminate_worker(ws)
        return {"ok": True}

    def _terminate_worker(self, ws: WorkerState):
        """SIGTERM a worker wherever it lives (head: direct child; remote:
        via its node agent, since a busy worker won't read an exit message)."""
        proc = self._worker_procs.get(ws.worker_id)
        if proc is not None:
            if proc.poll() is None:
                proc.terminate()
            return
        node = self.nodes.get(ws.node_id)
        if node is not None and node.conn is not None and node.alive:
            try:
                node.conn.post(
                    {"type": "kill_worker", "worker_id": ws.worker_id}
                )
            except ConnectionError:
                pass  # node dying; its workers die with it

    async def h_get_named_actor(self, conn, meta, msg):
        key = (msg.get("namespace", "default"), msg["name"])
        actor_hex = self.named_actors.get(key)
        if actor_hex is None:
            return {"handle": None}
        astate = self.actors.get(actor_hex)
        return {"handle": astate.handle_bytes if astate else None}

    # -------------------------------------------------------- worker death
    async def _on_worker_death(self, worker_id: str):
        ws = self.workers.get(worker_id)
        if ws is None:
            return
        prev_state = ws.state
        ws.state = DEAD
        self._leased_ids.discard(worker_id)
        ws.leased_to = None  # holder sees the direct conn close and recovers
        if ws.assigned:
            if not ws.blocked:
                self._grant_release(ws)
            else:  # capacity already released at block time
                ws.assigned = {}
                ws.assigned_pg = None
        self._worker_procs.pop(worker_id, None)
        if prev_state == BUSY and ws.current_task:
            dead_tasks = [(ws.current_task, True)]
            if ws.prefetch_task is not None:
                dead_tasks.append((ws.prefetch_task, False))
                ws.prefetch_task = None
            for task_hex, started in dead_tasks:
                entry = self.running.pop(task_hex, None)
                if entry is None:
                    continue
                _, pt = entry
                if task_hex in self.cancelled:
                    self._finish_cancelled(pt)
                elif not started:
                    # Prefetched-but-never-executed: plain requeue, no retry
                    # consumed (it would have still been in ready_queue
                    # without prefetch).
                    pt.pinned_node = None
                    self._enqueue(pt)
                else:
                    cause = (
                        f"Worker {worker_id} was killed by the memory "
                        f"monitor (node out of memory) while executing task"
                        if ws.oom_killed
                        else f"Worker {worker_id} died executing task"
                    )
                    self._retry_or_fail(pt, task_hex, cause)
        if prev_state == ACTOR and ws.actor_hex:
            await self._on_actor_worker_death(ws.actor_hex)
        # Keep the pool topped up. Queue-emptiness first: any() short-circuits
        # on the first idle worker, so a 5,000-actor kill wave doesn't pay a
        # full worker-table scan per death.
        if (self.ready_queue or self.waiting_tasks) and not any(
            w.state == IDLE for w in self.workers.values()
        ):
            self._spawn_worker()
        self._schedule()

    async def _on_actor_worker_death(self, actor_hex: str):
        astate = self.actors.get(actor_hex)
        if astate is None or astate.state == "dead":
            return
        spec = astate.spec
        max_restarts = spec.options.max_restarts if spec else 0
        # Calls delivered to the dead worker can never complete — fail exactly
        # those (tracked in `inflight`; queued-but-unsent calls are unaffected).
        from .exceptions import ActorUnavailableError

        if spec is not None and (max_restarts == -1 or astate.restarts_used < max_restarts):
            astate.restarts_used += 1
            self._set_actor_state(astate, "restarting")
            self._wal_append("actor_restarting", actor=actor_hex,
                             restarts_used=astate.restarts_used)
            self._event("actor_restarting", actor=actor_hex)
            err = TaskError(
                ActorUnavailableError(f"actor {actor_hex[:12]} restarting"), "", "actor task"
            )
            with astate.lock:  # pump (shard loop) writes concurrently
                inflight = list(astate.inflight.values())
                astate.inflight.clear()
            for ispec in inflight:
                self._unpin_args(ispec)
                if ispec.num_returns == -1:
                    self._fail_stream(ispec, err)  # streaming method call
                for oid in ispec.return_ids:
                    if self._obj(oid.hex()).status != "ready":
                        self._store_error_object(oid.hex(), err)
            self._pin_args(spec)  # restart creation re-reads its args
            pt = PendingTask(spec=spec, retries_left=0)
            self._enqueue(pt)
            self._schedule()
        else:
            self._set_actor_state(astate, "dead")
            self._wal_append("actor_death", actor=actor_hex)
            self._event("actor_death", actor=actor_hex,
                        restarts_used=astate.restarts_used)
            err = TaskError(ActorDiedError(), "", f"actor {actor_hex[:12]}")
            self._drain_actor_queue(astate, err)
            self._fail_streams_of_actor(actor_hex, err)
            with astate.lock:  # pump (shard loop) writes concurrently
                inflight = list(astate.inflight.values())
                astate.inflight.clear()
            for ispec in inflight:
                self._unpin_args(ispec)
                if ispec.num_returns == -1:
                    self._fail_stream(ispec, err)  # streaming method call
                for oid in ispec.return_ids:
                    if self._obj(oid.hex()).status != "ready":
                        self._store_error_object(oid.hex(), err)

    # ---------------------------------------------------------- node death
    async def _health_check_loop(self):
        """Active liveness probing of node agents (reference:
        `GcsHealthCheckManager`, `gcs_health_check_manager.h:39`): a wedged
        agent whose TCP connection is still up would otherwise hold its
        node 'alive' forever — connection-close detection only covers
        process death."""
        period = rt_config.get("health_check_period_s")
        timeout = rt_config.get("health_check_timeout_s")
        threshold = rt_config.get("health_check_failures")
        misses: Dict[str, int] = {}
        async def probe(node: NodeState):
            try:
                resp = await node.conn.request({"type": "ping"}, timeout=timeout)
                ok = bool((resp or {}).get("ok"))
                if ok and resp.get("sys"):
                    node.sys_metrics = resp["sys"]
                if ok:
                    node.agent_alive_workers = set(
                        resp.get("spawned_alive") or ()
                    )
            except Exception:  # noqa: BLE001
                ok = False
            if ok:
                misses.pop(node.node_id, None)
                return
            misses[node.node_id] = misses.get(node.node_id, 0) + 1
            if misses[node.node_id] >= threshold:
                self._event("node_health_check_failed", node=node.node_id)
                misses.pop(node.node_id, None)
                try:
                    node.conn.close()
                except Exception:  # noqa: BLE001
                    pass
                await self._on_node_death(node.node_id)

        from ..util.system_metrics import SystemMetricsSampler

        head_sampler = SystemMetricsSampler()
        while not self._shutdown_event.is_set():
            await asyncio.sleep(period)
            # Concurrent probes: one wedged node must not delay (or inflate
            # the detection latency of) every other node's probe.
            targets = [
                n for n in self.nodes.values() if n.alive and n.conn is not None
            ]
            if targets:
                await asyncio.gather(*(probe(n) for n in targets))
            try:
                self.head.sys_metrics = head_sampler.sample()
            except Exception:  # noqa: BLE001
                pass
            self._expire_spawn_ledger()
            if self.ready_queue and self._iso_booting:
                # Scheduling is event-driven; an isolated spawn that died
                # before registering produces NO event. This tick is what
                # advances the dead-attempt counter (_spawn_isolated) so a
                # broken env converges to RuntimeEnvSetupError instead of
                # hanging its tasks forever.
                self._schedule()

    def _expire_spawn_ledger(self):
        """Spawns that never registered (interpreter died / wedged) must
        give their boot budget back — a leaked `spawning` count would
        eventually starve the global worker_boot_concurrency cap."""
        now = time.monotonic()
        keep = []
        expired = False
        for entry in self._spawn_ledger:
            node_id, t0, tpu = entry
            if now - t0 < 180.0:
                keep.append(entry)
                continue
            expired = True
            node = self.nodes.get(node_id)
            if node is not None:
                node.spawning = max(0, node.spawning - 1)
                if tpu:
                    node.spawning_tpu = max(0, node.spawning_tpu - 1)
            self._event("spawn_expired", node=node_id)
        self._spawn_ledger = keep
        if expired:
            # Freed boot budget must re-fire deferred spawn demand — with a
            # blocked client and no other events, nothing else schedules.
            self._schedule()

    async def _on_node_death(self, node_id: str):
        """A node agent's connection dropped (reference analog: GCS node
        death pubsub after `GcsHealthCheckManager` misses)."""
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return
        node.alive = False
        self._fetch_conns.pop(node_id, None)
        self._event("node_died", node=node_id)
        # Tasks handed to its LocalDispatcher die with it — same retry
        # policy as worker death.
        marker = f"@{node_id}"
        for task_hex, (wid, pt) in list(self.running.items()):
            if wid == marker:
                self.running.pop(task_hex, None)
                self._retry_or_fail(
                    pt, task_hex, f"Node {node_id} died with task queued"
                )
        node.handoff_inflight = 0
        # Its workers are dying with it (PDEATHSIG); process them now so
        # running tasks retry immediately rather than on socket timeout.
        for ws in list(self.workers.values()):
            if ws.node_id == node_id and ws.state != DEAD:
                await self._on_worker_death(ws.worker_id)
        # Objects whose only copy lived there are lost (until lineage
        # reconstruction re-executes their creators).
        for hex_id, obj in self.objects.items():
            obj.locations.pop(node_id, None)
            if obj.spilled_path is not None and obj.spilled_node == node_id:
                obj.spilled_path = None
        # Re-place ONLY the bundles that sat on the dead node (reference
        # analog: `GcsPlacementGroupManager` rescheduling on node removal).
        # Bundles on surviving nodes keep their reservations untouched —
        # releasing them would double-book capacity still used by running
        # gang members.
        for pg_hex, pg in self.pgs.items():
            dead_idx = [
                i for i, nid in enumerate(pg["bundle_nodes"]) if nid == node_id
            ]
            if not dead_idx:
                continue
            dead_bundles = [pg["bundles"][i] for i in dead_idx]
            surviving = {
                nid for nid in pg["bundle_nodes"] if nid and nid != node_id
            }
            placement = self._place_bundles(
                dead_bundles, pg["strategy"], occupied=surviving
            )
            if placement is None:
                pg["ready"] = False  # blocks new PG dispatch; grants continue
                for i in dead_idx:
                    pg["bundle_nodes"][i] = None
                self._event("pg_infeasible_after_node_death", pg=pg_hex)
            else:
                for i, nid in zip(dead_idx, placement):
                    self._acquire(self.nodes[nid], pg["bundles"][i])
                    pg["bundle_nodes"][i] = nid
                    pg["bundle_avail"][i] = dict(pg["bundles"][i])
                self._event("pg_rescheduled", pg=pg_hex, bundles=dead_idx)
        self._schedule()

    # ------------------------------------------------------------ blocking
    # ------------------------------------------------------ memory monitor
    # Reference analog: `memory_monitor.h:52` sampling + the raylet's
    # worker-killing policy (`worker_killing_policy_group_by_owner.cc`).
    # Agents report candidates; the controller picks with global knowledge.
    async def h_memory_pressure(self, conn, meta, msg):
        node_id = msg.get("node_id", HEAD_NODE)
        victim = self._pick_oom_victim(node_id, msg.get("candidates") or [])
        if victim is None:
            return None
        victim.oom_killed = True
        self._event(
            "oom_kill", worker=victim.worker_id, node=node_id,
            used=msg.get("used"), limit=msg.get("limit"),
        )
        node = self.nodes.get(node_id)
        if node is not None and node.conn is not None:
            await node.conn.send(
                {"type": "kill_worker", "worker_id": victim.worker_id}
            )
        else:
            self._terminate_worker(victim)
        return None

    def _pick_oom_victim(self, node_id: str, candidates) -> Optional["WorkerState"]:
        """Largest-RSS TASK worker first; an actor host only when no task
        worker remains (the reference's policy spares actors the same way —
        killing one loses state, not just one retryable task)."""
        task_pick = actor_pick = None
        for worker_id, _rss in candidates:  # already sorted largest-first
            ws = self.workers.get(worker_id)
            if ws is None or ws.state == DEAD or ws.node_id != node_id:
                continue
            if ws.state == ACTOR:
                actor_pick = actor_pick or ws
            else:
                task_pick = task_pick or ws
                break
        return task_pick or actor_pick

    async def _head_memory_monitor_loop(self):
        """The head node has no agent — the controller samples its own
        spawned workers with the same policy."""
        from ..util.memory_monitor import MemoryPressureSampler

        interval = rt_config.get("memory_monitor_interval_s")
        if not interval:
            return
        sampler = MemoryPressureSampler(
            rt_config.get("memory_limit_bytes"),
            rt_config.get("memory_usage_threshold"),
        )
        while not self._shutdown_event.is_set():
            await asyncio.sleep(interval)
            try:
                over = sampler.over_threshold()
                if over is None:
                    continue
                pids = {
                    wid: p.pid for wid, p in list(self._worker_procs.items())
                    if p.poll() is None
                }
                if not pids:
                    continue
                await self.h_memory_pressure(
                    None, {},
                    {"node_id": HEAD_NODE,
                     "candidates": sampler.candidates(pids), **over},
                )
                await asyncio.sleep(interval)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    async def h_worker_blocked(self, conn, meta, msg):
        ws = self.workers.get(msg["worker_id"])
        if ws is not None and not ws.blocked:
            ws.blocked = True
            self._grant_release_keep(ws)
            self._schedule()
        return None

    async def h_worker_unblocked(self, conn, meta, msg):
        ws = self.workers.get(msg["worker_id"])
        if ws is not None and ws.blocked:
            ws.blocked = False
            self._grant_reacquire(ws)
        return None

    # ------------------------------------------------------------- cancel
    async def h_cancel(self, conn, meta, msg):
        task_hex = msg["task"]
        self.cancelled.add(task_hex)
        entry = self.running.get(task_hex)
        if entry is not None:
            worker_id, pt = entry
            if worker_id.startswith("@"):
                # Queued/running at a node agent: drop there; force also
                # kills the executing worker (the agent knows which one —
                # h_agent_task_cancelled / h_agent_task_lost finish the
                # bookkeeping).
                node = self.nodes.get(worker_id[1:])
                if node is not None and node.conn is not None and node.alive:
                    node.conn.post({"type": "cancel_task", "task": task_hex,
                                    "force": bool(msg.get("force"))})
                return {"ok": True}
            ws = self.workers.get(worker_id)
            if ws is not None and ws.prefetch_task == task_hex:
                # Prefetched but not yet executing: drop it on the worker —
                # force-killing would take down the UNRELATED current task.
                ws.prefetch_task = None
                self.running.pop(task_hex, None)
                try:
                    await ws.conn.send({"type": "drop_task", "task": task_hex})
                except Exception:  # noqa: BLE001
                    pass
                self._finish_cancelled(pt)
                self._schedule()
                return {"ok": True}
            if msg.get("force") and ws is not None:
                self._terminate_worker(ws)
        # Pending-in-queue tasks are culled in _schedule.
        pt = self.waiting_tasks.pop(task_hex, None)
        if pt is not None:
            self._finish_cancelled(pt)
        self._schedule()
        return {"ok": True}

    # ---------------------------------------------------- placement groups
    async def h_create_pg(self, conn, meta, msg):
        """Per-bundle placement onto nodes (reference analog:
        `BundleSchedulingPolicy` PACK/SPREAD/STRICT_* in
        `bundle_scheduling_policy.cc`). Reserves each bundle against a
        concrete node; bundle->node mapping drives bundle_index scheduling."""
        bundles: List[Dict[str, float]] = msg["bundles"]
        strategy = msg["strategy"]
        placement = self._place_bundles(bundles, strategy)
        feasible = placement is not None
        if feasible:
            for b, nid in zip(bundles, placement):
                self._acquire(self.nodes[nid], b)
        self.pgs[msg["id"]] = {
            "bundles": bundles,
            "strategy": strategy,
            "name": msg.get("name", ""),
            "ready": feasible,
            "bundle_nodes": placement or [],
            # Unconsumed capacity per bundle: PG tasks draw from here, not
            # from general node availability (it is already reserved).
            "bundle_avail": [dict(b) for b in bundles],
        }
        self._wal_append(
            "pg_created", pg=msg["id"], bundles=bundles, strategy=strategy,
            name=msg.get("name", ""), ready=feasible,
            bundle_nodes=placement or [],
        )
        return {"ok": feasible}

    def _place_bundles(
        self,
        bundles: List[Dict[str, float]],
        strategy: str,
        occupied: Optional[Set[str]] = None,
    ) -> Optional[List[str]]:
        """Map bundles to nodes per the PG strategy; None if infeasible.
        Works against a scratch copy of availability so partial placements
        never leak reservations. `occupied` seeds STRICT_SPREAD's used-node
        set (partial re-placement after a node death)."""
        alive = [n for n in self.nodes.values() if n.alive]
        avail = {n.node_id: dict(n.available) for n in alive}

        def fits(nid: str, b: Dict[str, float]) -> bool:
            a = avail[nid]
            return all(a.get(k, 0.0) + 1e-9 >= v for k, v in b.items())

        def take(nid: str, b: Dict[str, float]):
            a = avail[nid]
            for k, v in b.items():
                a[k] = a.get(k, 0.0) - v

        placement: List[str] = []
        if strategy in ("PACK", "STRICT_PACK"):
            order = sorted(avail, key=lambda nid: (nid != HEAD_NODE, nid))
            for b in bundles:
                chosen = None
                for nid in (placement[-1:] if strategy == "STRICT_PACK" and placement else []) + order:
                    if fits(nid, b):
                        chosen = nid
                        break
                if chosen is None:
                    return None
                if strategy == "STRICT_PACK" and placement and chosen != placement[0]:
                    return None
                take(chosen, b)
                placement.append(chosen)
            if strategy == "STRICT_PACK" and len(set(placement)) > 1:
                return None
            return placement
        # SPREAD / STRICT_SPREAD: round-robin across distinct nodes.
        used: Set[str] = set(occupied or ())
        for b in bundles:
            fresh = [nid for nid in sorted(avail) if nid not in used and fits(nid, b)]
            any_fit = [nid for nid in sorted(avail) if fits(nid, b)]
            if strategy == "STRICT_SPREAD":
                if not fresh:
                    return None  # needs a distinct node per bundle
                chosen = fresh[0]
            else:
                chosen = fresh[0] if fresh else (any_fit[0] if any_fit else None)
                if chosen is None:
                    return None
            take(chosen, b)
            placement.append(chosen)
            used.add(chosen)
        return placement

    async def h_pg_ready(self, conn, meta, msg):
        pg = self.pgs.get(msg["id"])
        return {"ready": bool(pg and pg["ready"])}

    async def h_pg_table(self, conn, meta, msg):
        pg = self.pgs.get(msg["id"])
        if pg is None:
            return {"pg": None}
        return {"pg": {k: pg[k] for k in ("bundles", "strategy", "name", "ready", "bundle_nodes")}}

    async def h_remove_pg(self, conn, meta, msg):
        pg = self.pgs.pop(msg["id"], None)
        if pg is not None:
            self._wal_append("pg_removed", pg=msg["id"])
        if pg and pg["bundle_nodes"]:
            # Release every still-placed bundle — including those of a PG
            # demoted to not-ready after a node death (its surviving bundles
            # keep reservations until removal).
            for b, nid in zip(pg["bundles"], pg["bundle_nodes"]):
                node = self.nodes.get(nid) if nid else None
                if node is not None and node.alive:
                    self._release(node, b)
            self._schedule()
        return {"ok": True}

    # ------------------------------------------------- streaming generators
    # Reference analog: `returns_dynamic` / ObjectRefGenerator
    # (`_raylet.pyx:272`) — a task's yields become objects as produced.
    def _stream(self, task_hex: str) -> dict:
        s = self.streams.get(task_hex)
        if s is None:
            s = self.streams[task_hex] = {"produced": 0, "done": False, "events": []}
        return s

    def _wake_stream(self, s: dict):
        for ev in s["events"]:
            ev.set()
        s["events"].clear()

    async def h_stream_item(self, conn, meta, msg):
        ws = self.workers.get(meta["worker_id"]) if meta.get("worker_id") else None
        node_id = ws.node_id if ws is not None else HEAD_NODE
        item = msg["item"]
        hex_id = item["id"]
        self._obj(hex_id).expected = True
        if item.get("inline") is not None:
            self._mark_ready(hex_id, inline=item["inline"], size=len(item["inline"]),
                             contains=item.get("contains"))
        else:
            self._mark_ready(hex_id, shm_name=item["name"], size=item["size"],
                             node_id=node_id, contains=item.get("contains"))
        s = self._stream(msg["task"])
        s["produced"] = max(s["produced"], msg["index"] + 1)
        self._wake_stream(s)
        return None

    async def h_stream_release(self, conn, meta, msg):
        """Consumer abandoned/finished the stream: indices it never claimed
        become GC-eligible (they were never announced as held), and the
        stream bookkeeping goes once the producer is done."""
        task_hex = msg["task"]
        s = self.streams.get(task_hex)
        if s is None:
            return None
        task_id = None
        for i in range(msg.get("from_index", 0), s["produced"]):
            if task_id is None:
                from .ids import TaskID

                task_id = TaskID.from_hex(task_hex)
            hex_id = ObjectID.of(task_id, i).hex()
            obj = self.objects.get(hex_id)
            if obj is not None:
                obj.ever_held = True  # unclaimed → GC-eligible
                self._maybe_gc(hex_id)
        if s["done"]:
            self.streams.pop(task_hex, None)
        return None

    async def h_stream_next(self, conn, meta, msg):
        """Long-poll for the consumer: next index ready | end | timeout."""
        task_hex, index = msg["task"], msg["index"]
        timeout = msg.get("timeout")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            s = self._stream(task_hex)
            if index < s["produced"]:
                return {"status": "ready"}
            if s["done"]:
                return {"status": "end"}
            # Dead-owner check: a streaming call queued in a dead actor's
            # worker (direct plane) produces no items and no done — only
            # the owning actor's state says so. Without this, the first
            # poll to race the death sweep long-polls out its full timeout.
            from .ids import TaskID

            try:
                owner = TaskID.from_hex(task_hex).actor_id().hex()
            except Exception:  # noqa: BLE001
                owner = None
            astate = self.actors.get(owner) if owner else None
            if astate is not None and astate.state == "dead":
                err = astate.init_error or TaskError(
                    ActorDiedError(), "", f"actor {owner[:12]}"
                )
                self._fail_stream_hex(task_hex, err)
                continue  # loop re-reads: first poll gets the error item
            ev = asyncio.Event()
            s["events"].append(ev)
            try:
                if deadline is None:
                    await ev.wait()
                else:
                    await asyncio.wait_for(
                        ev.wait(), max(0.0, deadline - time.monotonic())
                    )
            except asyncio.TimeoutError:
                return {"status": "timeout"}
            finally:
                if ev in s["events"]:
                    s["events"].remove(ev)

    # ---------------------------------------------------------------- jobs
    # Reference analog: `dashboard/modules/job/job_manager.py` — the job
    # runs as a supervised DRIVER subprocess on the head node; the client
    # (`JobSubmissionClient`) polls status and streams logs.
    async def h_submit_job(self, conn, meta, msg):
        import shlex

        job_id = f"job-{next(self._conn_counter):04d}-{os.getpid() % 10000}"
        entrypoint = msg["entrypoint"]
        runtime_env = msg.get("runtime_env") or {}
        env = dict(os.environ)
        env.update({k: str(v) for k, v in (runtime_env.get("env_vars") or {}).items()})
        env["RAY_TPU_ADDRESS"] = f"{self.node_ip}:{self.port}"
        env["RAY_TPU_JOB_ID"] = job_id
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["PYTHONUNBUFFERED"] = "1"
        cwd = runtime_env.get("working_dir") or pkg_root
        log_path = os.path.join(self.session_dir, f"{job_id}.log")
        try:
            proc = subprocess.Popen(
                shlex.split(entrypoint),
                env=env,
                stdout=open(log_path, "ab"),
                stderr=subprocess.STDOUT,
                cwd=cwd,
            )
        except OSError as e:
            return {"job_id": job_id, "status": "FAILED", "error": repr(e)}
        self.jobs[job_id] = {
            "proc": proc,
            "pid": proc.pid,
            "entrypoint": entrypoint,
            "status": "RUNNING",
            "log_path": log_path,
            "start_time": time.time(),
            "end_time": None,
        }
        self._event("job_submitted", job=job_id, entrypoint=entrypoint)
        return {"job_id": job_id, "status": "RUNNING"}

    def _job_view(self, job_id: str, j: dict) -> dict:
        proc = j.get("proc")
        if j["status"] == "RUNNING":
            if proc is not None:
                if proc.poll() is not None:
                    j["status"] = "SUCCEEDED" if proc.returncode == 0 else "FAILED"
                    j["end_time"] = time.time()
            elif not os.path.exists(f"/proc/{j.get('pid', 0)}"):
                # Re-adopted after controller restart: the job isn't our
                # child, so its exit code is unknowable.
                j["status"] = "UNKNOWN"
                j["end_time"] = time.time()
        return {
            "job_id": job_id,
            "status": j["status"],
            "entrypoint": j["entrypoint"],
            "returncode": proc.poll() if proc is not None else None,
            "start_time": j["start_time"],
            "end_time": j["end_time"],
        }

    async def h_job_status(self, conn, meta, msg):
        j = self.jobs.get(msg["job_id"])
        if j is None:
            return {"error": f"no such job {msg['job_id']}"}
        return self._job_view(msg["job_id"], j)

    async def h_list_jobs(self, conn, meta, msg):
        return {"jobs": [self._job_view(jid, j) for jid, j in self.jobs.items()]}

    async def h_job_logs(self, conn, meta, msg):
        j = self.jobs.get(msg["job_id"])
        if j is None:
            return {"error": f"no such job {msg['job_id']}"}
        try:
            with open(j["log_path"], "rb") as f:
                f.seek(msg.get("offset", 0))
                data = f.read(1 << 20)
            return {"data": data.decode(errors="replace"),
                    "offset": msg.get("offset", 0) + len(data)}
        except OSError:
            return {"data": "", "offset": 0}

    async def h_stop_job(self, conn, meta, msg):
        j = self.jobs.get(msg["job_id"])
        if j is None:
            return {"ok": False}
        proc = j.get("proc")
        try:
            if proc is not None and proc.poll() is None:
                proc.terminate()
                j["status"] = "STOPPED"
                j["end_time"] = time.time()
            elif proc is None and os.path.exists(f"/proc/{j.get('pid', 0)}"):
                os.kill(j["pid"], 15)  # re-adopted job (not our child)
                j["status"] = "STOPPED"
                j["end_time"] = time.time()
        except OSError:
            pass
        self._event("job_stopped", job=msg["job_id"])
        return {"ok": True}

    # ------------------------------------------------------ fault injection
    async def h_kill_worker(self, conn, meta, msg):
        """Chaos hook (reference: `WorkerKillerActor`, `test_utils.py:1527`)."""
        ws = self.workers.get(msg["worker_id"])
        if ws is None or ws.state == DEAD:
            return {"ok": False}
        self._terminate_worker(ws)
        self._event("chaos_worker_killed", worker=ws.worker_id)
        return {"ok": True}

    async def h_kill_node(self, conn, meta, msg):
        """Chaos hook: tell a node agent to exit (its workers die with it)."""
        node = self.nodes.get(msg["node_id"])
        if node is None or not node.alive or node.conn is None:
            return {"ok": False}
        await node.conn.send({"type": "exit"})
        self._event("chaos_node_killed", node=node.node_id)
        return {"ok": True}

    # -------------------------------------------------------------- state
    async def h_request_resources(self, conn, meta, msg):
        """Pin an explicit capacity floor for the autoscaler (reference:
        `ray.autoscaler.sdk.request_resources` → GCS resource_request)."""
        self._explicit_demands = [
            {k: float(v) for k, v in b.items()} for b in (msg.get("bundles") or [])
        ]
        return {"ok": True}

    async def h_load_metrics(self, conn, meta, msg):
        """Demand + utilization snapshot for `StandardAutoscaler.update`
        (reference: `LoadMetrics` fed from GCS — `load_metrics.py:63`)."""
        now = time.monotonic()
        # PG-bound tasks are excluded: their capacity is already reserved by
        # the PG's bundles, so counting them would launch nodes the tasks can
        # never use (they are pinned to the bundle's node).
        pending: List[Dict[str, float]] = [
            dict(pt.spec.resources)
            for pt in list(self.ready_queue)[:1000]
            if not isinstance(
                pt.spec.options.scheduling_strategy, PlacementGroupSchedulingStrategy
            )
        ]
        # Unsatisfied direct-path lease requests are queued demand too —
        # submitters buffer client-side and retry, so without this the
        # autoscaler would see an empty queue while work waits for capacity.
        for key, (demand, unmet, ts) in list(self._lease_backlog.items()):
            if now - ts > 5.0:
                self._lease_backlog.pop(key, None)
                continue
            pending.extend(dict(demand) for _ in range(min(unmet, 100)))
        pending_pgs = []
        for pg in self.pgs.values():
            if pg["ready"]:
                continue
            # Partially-placed PGs (node death) keep surviving reservations —
            # only the unplaced slots represent new demand.
            if pg["bundle_nodes"]:
                bundles = [
                    b
                    for b, nid in zip(pg["bundles"], pg["bundle_nodes"])
                    if nid is None
                ]
                occupied = sorted(
                    {nid for nid in pg["bundle_nodes"] if nid is not None}
                )
            else:
                bundles = pg["bundles"]
                occupied = []
            if bundles:
                # `occupied` lets the autoscaler's STRICT_SPREAD packer
                # exclude surviving nodes — the controller's re-placement
                # will refuse them, so capacity there cannot satisfy this PG.
                pending_pgs.append(
                    {
                        "bundles": bundles,
                        "strategy": pg["strategy"],
                        "occupied": occupied,
                    }
                )
        # Nodes hosting live workers with work or actors are busy even when
        # they hold zero resources (default actors are 0-CPU): terminating
        # such a node would destroy the actor.
        occupied_nodes = {
            ws.node_id
            for ws in self.workers.values()
            if ws.state != DEAD
            and (ws.state == ACTOR or ws.current_task is not None)
        }
        node_report = []
        for n in self.nodes.values():
            busy = any(v < t - 1e-9 for k, t in n.total.items()
                       for v in [n.available.get(k, 0.0)]) \
                or n.spawning > 0 or n.spawning_tpu > 0 \
                or n.node_id in occupied_nodes
            node_report.append(
                {
                    "node_id": n.node_id,
                    "alive": n.alive,
                    "is_head": n.node_id == HEAD_NODE,
                    "total": dict(n.total),
                    "available": dict(n.available),
                    "idle_s": 0.0 if busy else max(0.0, now - n.last_active),
                }
            )
        return {
            "pending_demands": pending,
            "pending_pgs": pending_pgs,
            "explicit_demands": list(self._explicit_demands),
            "nodes": node_report,
        }

    async def h_cluster_resources(self, conn, meta, msg):
        total = self._cluster_totals()
        avail: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.available.items():
                avail[k] = avail.get(k, 0.0) + v
        return {"total": total, "available": avail}

    async def h_nodes(self, conn, meta, msg):
        return {
            "nodes": [
                {
                    "NodeID": n.node_id,
                    "Alive": n.alive,
                    "Labels": dict(n.labels),
                    "Resources": dict(n.total),
                    "Available": dict(n.available),
                    "NodeManagerAddress": (self.node_ip if n.node_id == HEAD_NODE else n.fetch_addr.rsplit(":", 1)[0] if n.fetch_addr else ""),
                    "object_store_memory": n.object_store_memory
                    or self.object_store_memory,
                    "SystemMetrics": dict(n.sys_metrics),
                }
                for n in self.nodes.values()
            ]
        }

    async def h_flight_pull(self, conn, meta, msg):
        """Poke every live worker to flush its flight-recorder span ring
        NOW (one-way push; drained spans arrive over the task_events
        channel). `ray-tpu flight` and /api/flight call this before
        exporting so the merged trace is current rather than up to one
        flusher period stale."""
        n = 0
        for ws in list(self.workers.values()):
            if ws.state == DEAD or ws.conn is None or ws.conn._closed:
                continue
            try:
                ws.conn.post({"type": "flight_pull"})
                n += 1
            except ConnectionError:
                pass
        return {"ok": True, "workers": n}

    async def h_state_summary(self, conn, meta, msg):
        if msg.get("counts_only"):  # cheap status — no timeline payload
            return {
                "num_workers": len([w for w in self.workers.values() if w.state != DEAD]),
                "objects": len(self.objects),
                "store_bytes": self.store_bytes_used,
                "pending_tasks": len(self.ready_queue) + len(self.waiting_tasks),
                "running_tasks": len(self.running),
            }
        return {
            "timeline": list(self.timeline[-10000:]),
            "num_workers": len([w for w in self.workers.values() if w.state != DEAD]),
            "objects": len(self.objects),
            "store_bytes": self.store_bytes_used,
            "actors": {
                h: {"state": a.state, "name": a.name} for h, a in self.actors.items()
            },
            "pending_tasks": len(self.ready_queue) + len(self.waiting_tasks),
            "running_tasks": len(self.running),
        }

    # ------------------------------------------------- state API (listing)
    # Reference analogs: `python/ray/util/state/api.py` list_* +
    # `dashboard/state_aggregator.py`. Served straight from controller state.
    async def h_list_tasks(self, conn, meta, msg):
        out = []
        for pt in list(self.ready_queue):
            out.append({"task_id": pt.spec.task_id.hex(), "name": pt.spec.name,
                        "state": "PENDING_SCHEDULING",
                        "required_resources": pt.spec.resources})
        for task_hex, pt in self.waiting_tasks.items():
            out.append({"task_id": task_hex, "name": pt.spec.name,
                        "state": "PENDING_ARGS",
                        "deps_remaining": len(pt.deps_remaining)})
        for task_hex, (worker_id, pt) in self.running.items():
            ws = self.workers.get(worker_id)
            out.append({"task_id": task_hex, "name": pt.spec.name,
                        "state": "RUNNING", "worker_id": worker_id,
                        "node_id": ws.node_id if ws else "?"})
        for task_hex, info in list(self.direct_running.items()):
            ws = self.workers.get(info.get("worker_id", ""))
            if ws is None or ws.state == DEAD:
                self.direct_running.pop(task_hex, None)  # lazily reap
                continue
            out.append({"task_id": task_hex, "name": info.get("name", ""),
                        "state": "RUNNING", "worker_id": info["worker_id"],
                        "node_id": ws.node_id, "direct": True})
        return {"tasks": out}

    async def h_list_actors(self, conn, meta, msg):
        out = []
        for h, a in self.actors.items():
            ws = self.workers.get(a.worker_id) if a.worker_id else None
            out.append({
                "actor_id": h, "state": a.state.upper(), "name": a.name,
                "namespace": a.namespace, "worker_id": a.worker_id,
                "node_id": ws.node_id if ws else None,
                "restarts": a.restarts_used,
                "pending_calls": len(a.send_queue) + len(a.inflight),
            })
        return {"actors": out}

    async def h_poll_events(self, conn, meta, msg):
        """Cursor-based event subscription over the timeline (the same feed
        `_event` writes actor_restarting/actor_death/node_died into). A
        client passes its last cursor and an optional `kinds` filter and
        gets every matching event since — the gang supervisor's
        death-notification path (docs/ELASTIC_TRAINING.md). cursor=-1 means
        "subscribe from now" (returns no events, just the tail cursor)."""
        cursor = int(msg.get("cursor", -1))
        if cursor < 0:
            return {
                "cursor": self._timeline_base + len(self.timeline),
                "events": [],
            }
        pos = cursor - self._timeline_base
        if pos > len(self.timeline):
            # Cursor from a PREVIOUS controller incarnation (restore resets
            # the timeline): re-anchor to this incarnation's BASE and replay
            # its whole feed — anchoring to the tail instead silently
            # swallowed deaths that landed during the failover gap (a gang
            # member dying while its supervisor's poll was mid-retry). A
            # same-incarnation cursor can never run ahead of the tail, so
            # this branch is unambiguous; cursors BEHIND base (trimmed
            # history) still clamp forward to base below.
            pos = 0
        idx = max(pos, 0)
        kinds = set(msg.get("kinds") or ())
        # Floor of 1: limit<=0 would never advance the cursor — a silently
        # dead subscription instead of an error.
        limit = max(1, int(msg.get("limit", 2000)))
        events = []
        tl = self.timeline
        # The cursor advances only past SCANNED entries: when `limit` stops
        # the collection early, unreturned matches stay ahead of the cursor
        # for the next poll instead of being silently skipped.
        while idx < len(tl) and len(events) < limit:
            e = tl[idx]
            if not kinds or e.get("event") in kinds:
                events.append(e)
            idx += 1
        return {"cursor": self._timeline_base + idx, "events": events}

    async def h_list_objects(self, conn, meta, msg):
        limit = msg.get("limit", 1000)
        out = []
        for h, o in itertools.islice(self.objects.items(), limit):
            out.append({
                "object_id": h, "status": o.status, "size": o.size,
                "locations": list(o.locations), "spilled": bool(o.spilled_path),
                "holders": len(o.holders), "pinned": o.pinned,
            })
        return {"objects": out, "total": len(self.objects)}

    async def h_list_placement_groups(self, conn, meta, msg):
        return {
            "placement_groups": [
                {
                    "placement_group_id": pg_hex,
                    "name": pg.get("name", ""),
                    "strategy": pg["strategy"],
                    "state": "CREATED" if pg["ready"] else "PENDING",
                    "bundles": pg["bundles"],
                    "bundle_nodes": pg["bundle_nodes"],
                }
                for pg_hex, pg in self.pgs.items()
            ]
        }

    async def h_shard_info(self, conn, meta, msg):
        """Shard-layout introspection (coordination layer): the per-shard
        actor/worker partitions and lease holders. The FT test asserts the
        cross-shard invariants on this surface — every id in exactly one
        shard, shard routing matches the hash, no lease duplicated."""
        from .control_shards import HASH_NAME, shard_of

        shards = []
        for i, sh in enumerate(self.shards):
            shards.append({
                "index": i,
                "threaded": sh.threaded,
                "actors": sorted(sh.actors),
                "workers": sorted(sh.workers),
                "leases": sorted(
                    w.worker_id for w in list(sh.workers.values())
                    if w.state == LEASED
                ),
            })
        return {"n": len(self.shards), "hash": HASH_NAME, "shards": shards}

    async def h_list_workers(self, conn, meta, msg):
        return {
            "workers": [
                {"worker_id": w.worker_id, "state": w.state, "pid": w.pid,
                 "node_id": w.node_id, "has_tpu": w.has_tpu,
                 "current_task": w.current_task, "actor": w.actor_hex,
                 "direct_addr": w.direct_addr}
                for w in self.workers.values()
            ]
        }

    # -------------------------------------------------------- log tailing
    async def h_tail_logs(self, conn, meta, msg):
        """Incremental worker-log chunks (reference analog: `log_monitor.py`
        tailing worker files → driver). cursors: {worker_id: offset}. With
        init=True, returns current end-offsets and no data (a late-joining
        driver streams from 'now' instead of replaying history). Remote-node
        workers' files live on their agent — fetched over the agent conn."""
        cursors: Dict[str, int] = msg.get("cursors", {})
        only = msg.get("worker_id")
        init = bool(msg.get("init"))
        out = {}
        from .log_utils import read_log_chunk

        def one_head(ws: WorkerState):
            # Head-node files are read synchronously: spawning a coroutine
            # per worker per poll cost ~10ms/s of pure gather overhead at
            # 2,000 workers.
            path = os.path.join(self.session_dir, f"worker-{ws.worker_id}.log")
            if init:
                try:
                    out[ws.worker_id] = {"data": "", "offset": os.path.getsize(path)}
                except OSError:
                    pass
                return
            got = read_log_chunk(path, cursors.get(ws.worker_id, 0))
            if got is not None:
                data, offset = got
                out[ws.worker_id] = {
                    "data": data.decode(errors="replace"), "offset": offset
                }

        async def one(ws: WorkerState):
            node = self.nodes.get(ws.node_id)
            if node is None or not node.alive or node.conn is None:
                return
            try:
                resp = await node.conn.request(
                    {"type": "tail_log", "worker_id": ws.worker_id,
                     "offset": cursors.get(ws.worker_id, 0), "init": init},
                    timeout=10,
                )
            except Exception:  # noqa: BLE001
                return
            if resp and resp.get("offset") is not None:
                out[ws.worker_id] = {"data": resp.get("data", ""), "offset": resp["offset"]}

        remote = []
        heads = []
        for ws in list(self.workers.values()):
            if only and ws.worker_id != only:
                continue
            if ws.node_id == HEAD_NODE:
                heads.append(ws)
            else:
                remote.append(ws)
        if heads:
            # Off-loop: one stat per worker per poll blocked the event loop
            # ~200ms at 1,000 workers (syscalls are slow on the virtualized
            # bench hosts); the scheduler must not stall behind log tailing.
            def scan():
                for ws in heads:
                    one_head(ws)

            await asyncio.get_running_loop().run_in_executor(None, scan)
        if remote:
            await asyncio.gather(*(one(ws) for ws in remote))
        return {"logs": out}

    # -------------------------------------------------- prometheus metrics
    async def h_record_metric(self, conn, meta, msg):
        """User metrics (reference: `ray.util.metrics` Counter/Gauge/Histogram
        → `metrics_agent.py` Prometheus re-export). Histograms arrive as
        client-bucketed deltas (boundaries/buckets/sum/count) and aggregate
        here into real exposition families."""
        name, kind, value = msg["name"], msg["kind"], float(msg["value"])
        tags = tuple(sorted((msg.get("tags") or {}).items()))
        key = (name, tags)
        now = time.time()
        if msg.get("help"):
            self.user_metric_help.setdefault(name, str(msg["help"]))
        if kind == "histogram":
            boundaries = tuple(float(b) for b in msg.get("boundaries") or ())
            deltas = list(msg.get("buckets") or [])
            if len(deltas) != len(boundaries) + 1:
                return None  # malformed shipment; never poison the family
            h = self.user_hists.get(key)
            if h is None or h["boundaries"] != boundaries:
                # New series (or a reconfigured client changed boundaries —
                # restart the series rather than merging incompatible grids).
                h = self.user_hists[key] = {
                    "boundaries": boundaries,
                    "buckets": [0] * (len(boundaries) + 1),
                    "sum": 0.0, "count": 0,
                }
            h["buckets"] = [a + int(b) for a, b in zip(h["buckets"], deltas)]
            h["sum"] += float(msg.get("sum") or 0.0)
            h["count"] += int(msg.get("count") or 0)
            h["ts"] = now
        elif kind == "counter":
            cur = self.user_metrics.get(key, (0.0, None, 0.0))[0]
            self.user_metrics[key] = (cur + value, kind, now)
        else:  # gauge
            self.user_metrics[key] = (value, kind, now)
        return None

    async def h_prune_metrics(self, conn, meta, msg):
        """Drop user-metric series whose tags include all of msg['tags'] —
        called when a Serve replica drains so its gauges/histograms leave
        /metrics immediately instead of waiting out the staleness window."""
        match = {str(k): str(v) for k, v in (msg.get("tags") or {}).items()}
        if not match:
            return None
        for d in (self.user_metrics, self.user_hists):
            for key in [k for k in d if match.items() <= dict(k[1]).items()]:
                del d[key]
        return None

    def _prune_stale_metrics(self, now: float):
        cut = now - self._metric_staleness_s
        for key in [k for k, v in self.user_metrics.items() if v[2] < cut]:
            del self.user_metrics[key]
        for key in [k for k, v in self.user_hists.items() if v.get("ts", now) < cut]:
            del self.user_hists[key]

    def _prometheus_text(self) -> str:
        now = time.time()
        if self._wal is not None:
            # Scrape-time refresh (also keeps the gauge out of the
            # staleness sweep while the WAL lives).
            self._self_set_gauge(
                "controller_log_bytes", float(self._wal.total_bytes())
            )
        self._prune_stale_metrics(now)
        lines = [
            "# TYPE ray_tpu_tasks_pending gauge",
            f"ray_tpu_tasks_pending {len(self.ready_queue) + len(self.waiting_tasks)}",
            "# TYPE ray_tpu_tasks_running gauge",
            f"ray_tpu_tasks_running {len(self.running)}",
            "# TYPE ray_tpu_objects gauge",
            f"ray_tpu_objects {len(self.objects)}",
            "# TYPE ray_tpu_object_store_bytes gauge",
            f"ray_tpu_object_store_bytes {self.store_bytes_used}",
            "# TYPE ray_tpu_workers_alive gauge",
            f"ray_tpu_workers_alive {sum(1 for w in self.workers.values() if w.state != DEAD)}",
            "# TYPE ray_tpu_nodes_alive gauge",
            f"ray_tpu_nodes_alive {sum(1 for n in self.nodes.values() if n.alive)}",
            "# TYPE ray_tpu_actors gauge",
            f"ray_tpu_actors {sum(1 for a in self.actors.values() if a.state == 'alive')}",
        ]
        node_families: Dict[str, List[str]] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.available.items():
                node_families.setdefault("ray_tpu_node_resource_available", []).append(
                    f'ray_tpu_node_resource_available{{node="{_esc_label(n.node_id)}",'
                    f'resource="{_esc_label(k)}"}} {v}'
                )
            for k, v in n.sys_metrics.items():
                if k == "ts":
                    continue
                fam = _san_name(f"ray_tpu_node_{k}")
                node_families.setdefault(fam, []).append(
                    f'{fam}{{node="{_esc_label(n.node_id)}"}} {v}'
                )
        for fam, series in node_families.items():
            lines.append(f"# TYPE {fam} gauge")
            lines.extend(series)

        # User scalars, grouped into families so every series sits under one
        # # HELP/# TYPE header (scrapers misclassify bare counters otherwise).
        scalar_fams: Dict[str, List[Tuple[tuple, float]]] = {}
        fam_kind: Dict[str, str] = {}
        fam_raw: Dict[str, str] = {}
        for (name, tags), (value, kind, _ts) in self.user_metrics.items():
            fam = _san_name(name)
            scalar_fams.setdefault(fam, []).append((tags, value))
            fam_kind.setdefault(fam, kind)
            fam_raw.setdefault(fam, name)
        for fam, series in scalar_fams.items():
            help_text = self.user_metric_help.get(fam_raw[fam])
            if help_text:
                lines.append(f"# HELP {fam} {_esc_help(help_text)}")
            lines.append(f"# TYPE {fam} {fam_kind[fam] or 'gauge'}")
            for tags, value in series:
                tag_s = _format_tags(tags)
                lines.append(f"{fam}{{{tag_s}}} {value}" if tag_s else f"{fam} {value}")

        # Histograms: cumulative _bucket{le=...} + _sum + _count per series.
        hist_fams: Dict[str, List[Tuple[tuple, dict]]] = {}
        hist_raw: Dict[str, str] = {}
        for (name, tags), h in self.user_hists.items():
            fam = _san_name(name)
            hist_fams.setdefault(fam, []).append((tags, h))
            hist_raw.setdefault(fam, name)
        for fam, series in hist_fams.items():
            help_text = self.user_metric_help.get(hist_raw[fam])
            if help_text:
                lines.append(f"# HELP {fam} {_esc_help(help_text)}")
            lines.append(f"# TYPE {fam} histogram")
            for tags, h in series:
                tag_s = _format_tags(tags)
                cum = 0
                for b, cnt in zip(h["boundaries"], h["buckets"]):
                    cum += cnt
                    le = _format_le(b)
                    sep = "," if tag_s else ""
                    lines.append(f'{fam}_bucket{{{tag_s}{sep}le="{le}"}} {cum}')
                sep = "," if tag_s else ""
                lines.append(f'{fam}_bucket{{{tag_s}{sep}le="+Inf"}} {h["count"]}')
                lines.append(
                    f"{fam}_sum{{{tag_s}}} {h['sum']}" if tag_s else f"{fam}_sum {h['sum']}"
                )
                lines.append(
                    f"{fam}_count{{{tag_s}}} {h['count']}" if tag_s
                    else f"{fam}_count {h['count']}"
                )
        return "\n".join(lines) + "\n"

    async def _on_metrics_connection(self, reader, writer):
        """Minimal HTTP/1.0 responder for GET /metrics (Prometheus text)."""
        try:
            line = await asyncio.wait_for(reader.readline(), 5)
            while True:  # drain headers
                h = await asyncio.wait_for(reader.readline(), 5)
                if h in (b"\r\n", b"\n", b""):
                    break
            body = self._prometheus_text().encode()
            path = line.split(b" ")[1] if len(line.split(b" ")) > 1 else b"/"
            if not path.startswith(b"/metrics"):
                writer.write(b"HTTP/1.0 404 Not Found\r\nContent-Length: 0\r\n\r\n")
            else:
                writer.write(
                    b"HTTP/1.0 200 OK\r\nContent-Type: text/plain; version=0.0.4\r\n"
                    + f"Content-Length: {len(body)}\r\n\r\n".encode()
                    + body
                )
            await writer.drain()
        except Exception:  # noqa: BLE001
            pass
        finally:
            writer.close()

    def _trim_timeline(self):
        """Cap + cursor-base bookkeeping MUST move together: dropping
        entries without advancing _timeline_base would silently shift
        every poll_events cursor by the truncation amount."""
        if len(self.timeline) > 100_000:
            del self.timeline[:50_000]
            self._timeline_base += 50_000

    # High-volume lifecycle kinds subject to the storm cap (the task-events
    # 4096-cap pattern applied to the ACTOR lifecycle): a 10k-actor wave
    # must not spend its controller time narrating itself into the
    # timeline. Death/restart/failure kinds are EXEMPT — poll_events
    # subscribers (the elastic-training gang supervisor) depend on them.
    _STORM_KINDS = frozenset({
        "worker_spawn", "worker_registered", "actor_created", "actor_alive",
        "actor_readopted", "task_submitted", "task_dispatched", "task_done",
        "task_handoff", "lease_granted",
    })
    _STORM_WINDOW_S = 1.0
    _STORM_CAP = 4096

    def _event(self, kind: str, **fields):
        if kind in self._STORM_KINDS:
            now = time.monotonic()
            st = getattr(self, "_storm_state", None)
            if st is None:
                st = self._storm_state = [now, 0, 0]  # window t0, count, dropped
            if now - st[0] >= self._STORM_WINDOW_S:
                if st[2]:
                    self.timeline.append({
                        "ts": time.time(), "event": "actor_events_dropped",
                        "n": st[2],
                    })
                st[0], st[1], st[2] = now, 0, 0
            st[1] += 1
            if st[1] > self._STORM_CAP:
                st[2] += 1
                return
        self.timeline.append({"ts": time.time(), "event": kind, **fields})
        self._trim_timeline()


async def run_controller(args: dict):
    ctrl = Controller(
        num_cpus=args["num_cpus"],
        resources=args.get("resources", {}),
        session_dir=args["session_dir"],
        object_store_memory=args.get("object_store_memory"),
        port=args.get("port", 0),
        standalone=bool(args.get("standalone")),
    )
    await ctrl.start(restore=bool(args.get("restore")))
    # Handshake: parent reads this line to learn the port.
    print(f"RAY_TPU_CONTROLLER_PORT={ctrl.port}", flush=True)
    await ctrl.serve_forever()
