"""Central flag registry (reference: `src/ray/common/ray_config_def.h` — 220
`RAY_CONFIG(type, name, default)` entries behind a singleton, overridable by
env vars on every process).

Every tunable lives HERE with its default; any process overrides any flag
with `RAY_TPU_<NAME>` in its environment. `get()` is cheap (cached after
first read) — safe in hot paths.

    from ray_tpu_torch.core import config
    config.get("gc_grace_s")          # -> 1.0, or RAY_TPU_GC_GRACE_S env
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    type: Callable
    doc: str


_REGISTRY: Dict[str, Flag] = {}
_CACHE: Dict[str, Any] = {}
_LOCK = threading.Lock()


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


def define(name: str, default: Any, type_: Callable = None, doc: str = ""):
    if type_ is None:
        type_ = _parse_bool if isinstance(default, bool) else type(default)
    _REGISTRY[name] = Flag(name, default, type_, doc)


def get(name: str) -> Any:
    try:
        return _CACHE[name]
    except KeyError:
        pass
    flag = _REGISTRY.get(name)
    if flag is None:
        raise KeyError(f"Unknown config flag {name!r}; known: {sorted(_REGISTRY)}")
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    value = flag.default if raw is None else flag.type(raw)
    with _LOCK:
        _CACHE[name] = value
    return value


def all_flags() -> Dict[str, Any]:
    """Resolved view of every flag (for `ray-tpu status`/debugging)."""
    return {name: get(name) for name in sorted(_REGISTRY)}


def _reset_cache_for_tests():
    with _LOCK:
        _CACHE.clear()


# ----------------------------------------------------------------- defaults
# Object plane.
define("inline_threshold_bytes", 64 * 1024,
       doc="Objects at or below this ride the control plane inline")
define("object_store_fraction", 0.3,
       doc="Fraction of system memory for the default object store size")
define("log_chunk_bytes", 256 * 1024, doc="Max bytes per log-tail poll")
# Ref counting / GC.
define("gc_grace_s", 1.0,
       doc="Delay before freeing a holderless object (absorbs in-flight adds)")
define("gc_sweep_interval_s", 0.4, doc="GC candidate sweep period")
define("ref_flush_interval_s", 0.25, doc="Client ref-transition batch period")
define("lineage_cap", 20_000, doc="Max task specs retained for reconstruction")
# Scheduler / workers.
define("scheduler_scan_window", 64,
       doc="Ready-queue head scan bound per scheduling pass")
define("max_workers_per_cpu", 4, doc="Worker pool cap = cpus × this")
define("worker_prestart_cap", 6, doc="Max head workers prestarted per pass")
define("spawn_burst_cap", 4, doc="Max workers spawned per node per pass")
define("worker_boot_concurrency", 16,
       doc="Cluster-wide cap on simultaneously BOOTING workers — interpreter "
           "start is ~2s of CPU; unbounded bursts thrash the machine")
# Sharded control plane (control_shards.py).
define("controller_shards", 4,
       doc="Partitions of the hot actor/lease/worker directories (crc32 of "
           "the id, mod this); each shard's event loop owns its actors' "
           "delivery plane")
define("controller_shard_threads", True,
       doc="Run each shard's loop on its own thread; off = inline mode "
           "(all shards execute on the controller's main loop — same "
           "partitioning, single executor)")
# Persistence.
define("snapshot_interval_s", 1.0,
       doc="Controller checkpoint period (with the WAL on, a checkpoint is "
           "log COMPACTION, not the durability boundary)")
define("gcs_storage", "file",
       doc="Metadata backend url: file[://dir] (durable) | memory (volatile)")
# Write-ahead event log (core/event_log.py — the GCS replay role).
define("wal_enabled", True,
       doc="Append every state-mutating control-plane transition to the "
           "session-dir WAL; restore = checkpoint + replay (sub-second "
           "actor-state recovery). Active only for standalone controllers "
           "with a durable gcs_storage backend")
define("wal_segment_bytes", 8 * 1024 * 1024,
       doc="WAL segment rotation size; checkpoints unlink covered segments")
define("wal_fsync_interval_s", 0.05,
       doc="WAL fsync batching window (loss bound for machine crashes; "
           "process kill -9 loses nothing written)")
define("wal_fsync_bytes", 256 * 1024,
       doc="Dirty-byte threshold that forces an immediate WAL fsync")
define("wal_sync", "batch",
       doc="WAL durability mode: batch (fsync-batched, default) | always "
           "(fsync per append — chaos tests) | none")
# Head failover (client side).
define("head_reconnect_deadline_s", 30.0,
       doc="How long drivers/agents retry reconnecting to a restarting "
           "head (capped exponential backoff) before declaring it dead")
define("readopt_deadline_s", 40.0,
       doc="After a head restore, how long restored actors wait for their "
           "surviving worker to reconnect before the normal death/restart "
           "path runs (raise for huge fleets on starved hosts — the "
           "re-registration storm itself takes time)")
define("pull_timeout_s", 120.0, doc="Cross-node object pull base timeout")
# Chunked transfer plane (reference: object_manager chunked push/pull,
# `object_manager.h` default chunk 5 MiB; admission `pull_manager.h:52`).
define("transfer_chunk_bytes", 16 * 1024 * 1024,
       doc="Cross-node transfers stream in chunks of this size")
define("transfer_chunk_parallel", 4,
       doc="In-flight chunks per object pull")
define("transfer_chunk_timeout_s", 60.0,
       doc="Per-chunk progress deadline (replaces whole-object timeouts)")
define("transfer_max_pulls", 4,
       doc="Concurrent object pulls a node admits (admission control)")
# Bulk plane (bulk.py): sendfile/recv_into raw-socket transfers; the msgpack
# RPC chunk plane above remains the fallback when no bulk endpoint is known.
define("bulk_streams", 4,
       doc="Parallel connections (contiguous spans) per bulk object pull")
define("bulk_pipeline", True,
       doc="Overlap the TCP recv of one chunk with the landing pwrite of "
           "the previous (bounded reader/lander window per span); off = "
           "the serial recv-then-write loop")
define("bulk_chunk_bytes", 16 * 1024 * 1024,
       doc="Chunk size for the pipelined bulk landing (8-32 MiB sweet "
           "spot: big enough to amortize the thread handoff, small enough "
           "that the window fits in cache-adjacent memory)")
define("bulk_window_chunks", 4,
       doc="Max chunk buffers in flight per span (reader + landers); "
           "bounds staging memory at chunk*window per stream")
define("bulk_land_threads", 1,
       doc="Lander threads per span for the pipelined bulk landing "
           "(pwrites are positional, so >1 is safe; helps only when the "
           "receiver has spare cores)")
define("bulk_native_lander", "auto",
       doc="Off-GIL landing for bulk pulls (native/src/bulk.cpp): 'stream' "
           "runs the whole poll/read/pwrite receive loop in one native call "
           "(payload never passes through Python), 'ring' keeps the Python "
           "recv_into but lands chunks on a native pinned thread consuming "
           "a descriptor ring, 'off' forces the pure-Python paths, 'auto' "
           "= stream when the extension builds. Overrides bulk_pipeline / "
           "bulk_land_threads (those govern the Python fallback)")
define("bulk_rcvbuf_bytes", 8 * 1024 * 1024,
       doc="SO_RCVBUF for bulk pull connections (0 = kernel default): a "
           "deep receive window lets the sender stream across receiver "
           "scheduling gaps; clamped by net.core.rmem_max")
define("put_stripe_threads", 2,
       doc="Threads striping one large buffer's pwrite on the put path "
           "(page-supply on lazily-backed guests scales past one core; "
           "buffers under put_stripe_min_bytes stay single-threaded)")
define("put_stripe_min_bytes", 256 * 1024 * 1024,
       doc="Minimum buffer size for striped put-path writes")
define("bulk_min_bytes", 1 << 20,
       doc="Use the sendfile bulk plane for objects at least this large")
define("bulk_same_host_map", True,
       doc="Same-host pulls pread the source shm file directly (plasma "
           "fd-passing by name) instead of looping through TCP")
define("transfer_log_big", True,
       doc="Log one stderr line per big (>=256 MiB) object transfer with "
           "plane + throughput attribution (session-log forensics; set 0 "
           "to silence)")
define("bulk_same_host_borrow", True,
       doc="Same-host pulls ADOPT the source span zero-copy (borrow name + "
           "pin held at the source until released) instead of copying it — "
           "the plasma shared-segment design; the page-supply-bound copy "
           "path remains the fallback and the cross-machine behavior")
define("iso_boot_grace_s", 30.0,
       doc="Seconds an isolated (conda/container) worker spawn may take to "
           "register before it counts as a dead attempt (the window widens "
           "per attempt: x1, x2, x3 -> 3 min total by default — REMOTE "
           "agent spawns are unobservable from the head, so slow image "
           "pulls must not be misread as dead); 3 dead attempts mark the "
           "(node, env) unavailable")
define("arena_prefault", True,
       doc="Fault the arena mapping in once at creation (background): tmpfs "
           "pages stay guest-resident for the file's life, so every later "
           "object write runs at warm-page speed (see core/mem.py)")
define("worker_forkserver", True,
       doc="Per-node pre-imported template process; CPU workers fork from "
           "it in ~10ms instead of booting an interpreter (~2s)")
# Data plane (ray_tpu_torch/data): exchange block traffic over the bulk planes.
define("data_block_transport", True,
       doc="Shuffle-exchange map outputs land as ONE flat arena segment per "
           "task (pickle-5 frame, columns as out-of-band buffers at known "
           "offsets) and reduce tasks pull only their partition's byte span "
           "over the bulk plane (data/transport.py); off = the classic "
           "per-partition pickled object puts (num_returns=P)")
define("data_node_strict", False,
       doc="Block-transport locality decided by logical NODE ID instead of "
           "host IP: on a one-box multi-node cluster (cluster_utils, "
           "bench_data --nodes N) every node shares the IPs and /dev/shm, "
           "so without this flag the 'cross-node' TCP span path never "
           "engages; strict mode makes such clusters behave like real "
           "multi-machine ones (see data/transport.py node_strict)")
# Two-level scheduling (reference: ClusterTaskManager/LocalTaskManager split).
define("local_dispatch", True,
       doc="Hand queued plain tasks to node agents' LocalDispatchers; the "
           "agent leases local workers and dispatches without the head")
define("local_dispatch_depth", 4,
       doc="Handoff queue depth per node, in multiples of its CPU count")
define("local_dispatch_spill_s", 10.0,
       doc="Agent-queued tasks with no obtainable lease for this long "
           "spill back to central scheduling")
define("transfer_pulls_per_source", 2,
       doc="Concurrent pulls served per source copy before fan-out waits "
           "for new copies (yields tree-shaped broadcast)")
# Networking (reference: `node_ip_address` plumbed through every process,
# `services.py:295-305`). node_ip is what THIS machine advertises to the
# cluster; bind_address is the listen interface (empty = node_ip).
define("node_ip", "127.0.0.1",
       doc="Address this node advertises to peers (head: controller addr; "
           "workers/agents: their fetch addr)")
define("bind_address", "",
       doc="Interface RPC servers bind; empty = node_ip, 0.0.0.0 = all")
# Observability.
define("dashboard", True, doc="Serve the HTTP dashboard from the controller")
define("dashboard_port", 0, doc="Dashboard port (0 = ephemeral)")
# Memory monitor (reference: `memory_monitor.h:52` + worker-killing policy).
define("memory_monitor_interval_s", 1.0,
       doc="Node memory-pressure sampling period (0 disables)")
define("memory_usage_threshold", 0.95,
       doc="Fraction of node memory that triggers worker killing")
define("memory_limit_bytes", 0,
       doc="Absolute node memory budget (0 = threshold x total); tests use "
           "this to trigger the policy without exhausting the machine")
# Failure detection (reference: `gcs_health_check_manager.h:55`).
define("health_check_period_s", 5.0, doc="Node agent liveness probe period")
define("health_check_timeout_s", 2.0, doc="Per-probe response deadline")
define("health_check_failures", 3, doc="Consecutive misses before node death")
