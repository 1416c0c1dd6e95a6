"""Compiled DAGs (reference: `python/ray/dag/compiled_dag_node.py`, 495 LoC).

Compiles a static task graph onto long-lived actors connected by reusable
shared-memory channels: after compile, `execute()` does ZERO task
submissions — the driver writes the input channel, every stage actor sits in
a read→compute→write loop, and the result appears in the output channel.
This is the substrate for cross-host pipeline stages (the in-jit GPipe path
for a single mesh lives in `ray_tpu_torch.parallel.pipeline`; the MPMD training
pipeline in `ray_tpu_torch.train.mpmd` builds its stage-to-stage edges through
`make_edge_channel` below). Channels grow on demand past the 1 MiB default;
per-round get() deadlines are configurable via execute(timeout=...); stage
exceptions travel the pipeline as StageError values and re-raise at the
caller, and a DEAD stage host surfaces as a stage-death error within the
health-poll window instead of a bare channel timeout.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ..experimental.channel import Channel, ChannelClosed
from ..experimental.tcp_channel import TcpChannel
from . import ActorMethodNode, ClassNode, DAGNode, InputNode, MultiOutputNode


def _advertise_host() -> str:
    from ..core import config

    return config.get("node_ip") or "127.0.0.1"


class StageError:
    """A stage-host exception travelling the pipeline as DATA: the failing
    stage publishes it downstream instead of its result, every later stage
    forwards it untouched (first error wins), and `CompiledDAGRef.get`
    re-raises it at the caller. The exec loops stay alive — channel seqs
    advanced exactly one round, so the next execute() is coherent."""

    __slots__ = ("stage", "exc", "repr", "tb")

    def __init__(self, stage: str, exc: BaseException, tb: str):
        import pickle

        self.stage = stage
        self.repr = repr(exc)
        self.tb = tb
        try:
            # Probe with PLAIN pickle — the channels transport values with
            # pickle, not cloudpickle, so a __main__-defined exception class
            # (common: user stage code ships by value via cloudpickle) must
            # be dropped here or it would kill the exec loop mid-write and
            # wedge the very pipeline this class exists to keep alive.
            pickle.loads(pickle.dumps(exc))
            self.exc = exc
        except Exception:  # noqa: BLE001
            self.exc = None

    def raise_(self):
        err = RuntimeError(
            f"compiled DAG stage {self.stage!r} raised {self.repr}\n{self.tb}"
        )
        if self.exc is not None:
            raise err from self.exc
        raise err


def make_edge_channel(
    buffer_size: int,
    producer_node: str,
    consumer_nodes: List[str],
    n_readers: int,
    bind_actor,
    driver_node: str,
):
    """Create the right channel type for one edge: shm seqlock when the
    producer and every consumer share a node (created remotely through
    `bind_actor.create_shm_channel` when that node isn't the driver's),
    persistent TCP otherwise. `bind_actor` is any actor exposing the
    `bind_tcp_channel`/`create_shm_channel` surface (`_StageHost` here; the
    MPMD trainer's stage replicas reuse this for their activation/grad
    edges), or None when the producer is the driver itself."""
    import ray_tpu_torch

    from ..experimental.channel import RemoteShmChannel

    if all(c == producer_node for c in consumer_nodes):
        if producer_node == driver_node or bind_actor is None:
            return Channel(buffer_size, num_readers=n_readers)
        # Edge entirely on a remote node: the segment must be created
        # THERE; the driver keeps a no-mapping descriptor.
        name = ray_tpu_torch.get(
            bind_actor.create_shm_channel.remote(buffer_size, n_readers)
        )
        return RemoteShmChannel(name, n_readers)
    name = f"rtpuch-{uuid.uuid4().hex[:12]}"
    if bind_actor is None:  # producer is the driver (input channel)
        return TcpChannel.bind(name, n_readers, advertise_host=_advertise_host())
    addr = ray_tpu_torch.get(bind_actor.bind_tcp_channel.remote(name, n_readers))
    return TcpChannel(name, tuple(addr), n_readers)


class ChannelHostMixin:
    """The channel-construction surface `make_edge_channel` needs from an
    edge-producing actor. Shared by the compiled-DAG `_StageHost` and the
    MPMD trainer's stage replicas — the create_shm_channel ownership
    bookkeeping (keeping the segment tracker-registered in its CREATING
    process) must not drift between the two."""

    def node_id(self) -> str:
        from ..core.runtime_context import get_runtime_context

        return get_runtime_context().get_node_id()

    def bind_tcp_channel(self, name: str, num_readers: int) -> Tuple[str, int]:
        """Bind the writer end of a cross-host edge in this process and
        return the address readers should dial (reference analog: the
        producer registers the channel with its local raylet,
        `python/ray/experimental/channel.py:49`)."""
        ch = TcpChannel.bind(name, num_readers, advertise_host=_advertise_host())
        return ch.addr

    def create_shm_channel(self, buffer_size: int, num_readers: int) -> str:
        """Create a shm channel ON THIS NODE for an edge whose producer and
        consumers all live here but the driver doesn't — the driver can't
        create the segment remotely, so it asks the producer to (and keeps
        only a no-mapping descriptor)."""
        ch = Channel(buffer_size, num_readers=num_readers)
        if not hasattr(self, "_owned_channels"):
            self._owned_channels = []
        self._owned_channels.append(ch)  # keep tracker registration alive
        return ch.name


class _StageHost(ChannelHostMixin):
    """Generic actor hosting one compiled stage's user object + exec loop.

    NOTE: the exec loop runs as one long actor task (`run_loop`), exactly the
    reference's design — teardown writes a stop sentinel through the input
    channels, which unblocks and ends the loop.
    """

    def __init__(self, serialized_cls: bytes, serialized_init: bytes):
        cls = cloudpickle.loads(serialized_cls)
        args, kwargs = cloudpickle.loads(serialized_init)
        self._obj = cls(*args, **kwargs)

    def ping(self) -> str:
        return "ok"

    def run_loop(self, stages: List[Tuple[str, List[Tuple[str, Any]], Channel]]) -> int:
        """One loop task per actor, executing ALL of this actor's stages in
        topological order each round (ordered actor queues mean a second
        blocking task would never start). Stage: (method_name, arg_plan,
        out_channel); arg_plan entries: ("chan", Channel) | ("const", value)
        | ("dup", earlier_arg_index) — a channel bound to two params of one
        stage is read ONCE per round and its value reused.
        """
        import traceback

        rounds = 0
        closed = False
        try:
            while not closed:
                for method_name, arg_plan, out_channel in stages:
                    args, reads = [], []
                    try:
                        for kind, v in arg_plan:
                            if kind == "chan":
                                args.append(v.begin_read())
                                reads.append(v)
                            elif kind == "dup":
                                args.append(args[v])
                            else:
                                args.append(v)
                    except ChannelClosed:
                        closed = True
                        break
                    # An upstream failure arrives as a StageError value:
                    # forward it (first error wins) without running this
                    # stage — the round still advances every channel once.
                    upstream = next(
                        (a for a in args if isinstance(a, StageError)), None
                    )
                    try:
                        if upstream is not None:
                            result = upstream
                        else:
                            try:
                                result = getattr(self._obj, method_name)(*args)
                            except BaseException as e:  # noqa: BLE001
                                result = StageError(
                                    method_name, e, traceback.format_exc()
                                )
                    finally:
                        for c in reads:
                            c.end_read()
                    out_channel.write(result)
                else:
                    rounds += 1
        finally:
            for _, _, out_channel in stages:
                out_channel.close_writer()
        return rounds


class CompiledDAG:
    def __init__(self, root: DAGNode, buffer_size_bytes: int = 1 << 20):
        self._buffer_size = buffer_size_bytes
        self._outputs: List[DAGNode] = (
            list(root._bound_args) if isinstance(root, MultiOutputNode) else [root]
        )
        self._teardown_done = False
        self._execute_count = 0
        self._compile()

    # ------------------------------------------------------------- compile
    def _compile(self):
        import ray_tpu_torch

        # Topological order over ActorMethodNodes.
        order: List[ActorMethodNode] = []
        seen = set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            if isinstance(node, ActorMethodNode):
                for a in list(node._bound_args) + list(node._bound_kwargs.values()):
                    visit(a)
                order.append(node)
            elif isinstance(node, MultiOutputNode):
                for a in node._bound_args:
                    visit(a)

        for out in self._outputs:
            visit(out)
        if not order:
            raise ValueError("Compiled DAGs need at least one bound actor method")
        for node in order:
            if node._bound_kwargs:
                raise ValueError("Compiled DAGs support positional args only")
            if not isinstance(node._target, ClassNode):
                raise ValueError(
                    "Compiled DAG stages must be methods of ClassNode actors "
                    "(cls.bind(...).method.bind(...))"
                )

        # Count DISTINCT consuming stages per producer (a stage binding the
        # same upstream twice reads its channel once per round) + the driver
        # for output nodes. Each consumer gets its own ack slot.
        consumer_stages: Dict[int, set] = {}
        input_consumer_stages: set = set()
        for node in order:
            for a in node._bound_args:
                if isinstance(a, InputNode):
                    input_consumer_stages.add(id(node))
                elif isinstance(a, ActorMethodNode):
                    consumer_stages.setdefault(id(a), set()).add(id(node))
        driver_reads = {id(out) for out in self._outputs}
        num_readers = {
            pid: len(stages) + (1 if pid in driver_reads else 0)
            for pid, stages in consumer_stages.items()
        }
        for pid in driver_reads:
            num_readers.setdefault(pid, 1)

        # Create one _StageHost per distinct ClassNode, carrying the user's
        # actor options (resources / scheduling strategy) so stages land
        # where the DAG author placed them.
        self._ray = ray_tpu_torch
        from ..core.actor import ActorClass

        self._actors: Dict[int, Any] = {}
        for node in order:
            cn: ClassNode = node._target
            if id(cn) not in self._actors:
                if any(isinstance(a, DAGNode) for a in cn._bound_args) or any(
                    isinstance(v, DAGNode) for v in cn._bound_kwargs.values()
                ):
                    raise ValueError(
                        "Compiled DAG actor constructors take constants only"
                    )
                StageActor = ActorClass(_StageHost, cn._actor_cls._default_options)
                self._actors[id(cn)] = StageActor.remote(
                    cloudpickle.dumps(cn._actor_cls.cls),
                    cloudpickle.dumps((cn._bound_args, cn._bound_kwargs)),
                )
        ray_tpu_torch.get([a.ping.remote() for a in self._actors.values()])

        # Channel type is chosen per edge: shm seqlock when the producer and
        # every consumer share a node, persistent TCP otherwise (the
        # cross-host pipeline path — SURVEY §7 "compiled multi-host
        # pipelines"; reference substrate `experimental/channel.py:49`).
        from ..core.runtime_context import get_runtime_context

        driver_node = get_runtime_context().get_node_id()
        actor_nodes: Dict[int, str] = dict(
            zip(
                self._actors.keys(),
                ray_tpu_torch.get([a.node_id.remote() for a in self._actors.values()]),
            )
        )
        stage_node = {id(n): actor_nodes[id(n._target)] for n in order}

        def make_channel(producer_node, consumer_nodes, n_readers, bind_actor):
            return make_edge_channel(
                self._buffer_size, producer_node, consumer_nodes, n_readers,
                bind_actor, driver_node,
            )

        self._input_channel: Optional[Channel] = None
        if input_consumer_stages:
            in_consumer_nodes = [
                stage_node[sid] for sid in input_consumer_stages
            ]
            self._input_channel = make_channel(
                driver_node, in_consumer_nodes, len(input_consumer_stages), None
            )
        self._channels: Dict[int, Channel] = {}
        for node in order:
            pid = id(node)
            if pid not in num_readers:
                continue
            consumer_nodes = [
                stage_node[sid] for sid in consumer_stages.get(pid, ())
            ]
            if pid in driver_reads:
                consumer_nodes.append(driver_node)
            self._channels[pid] = make_channel(
                stage_node[pid],
                consumer_nodes,
                num_readers[pid],
                self._actors[id(node._target)],
            )
        self._all_channels = list(self._channels.values()) + (
            [self._input_channel] if self._input_channel else []
        )
        self._next_slot: Dict[str, int] = {}  # channel name -> next reader slot

        # One exec-loop task per actor, covering all its stages in topo order.
        def take_slot(ch: Channel) -> Channel:
            slot = self._next_slot.get(ch.name, 0)
            self._next_slot[ch.name] = slot + 1
            return ch.with_reader_slot(slot)

        per_actor: Dict[int, List] = {}
        for node in order:
            arg_plan: List[Tuple[str, Any]] = []
            chan_arg_idx: Dict[str, int] = {}  # channel name -> arg index (dedup)
            for i, a in enumerate(node._bound_args):
                if isinstance(a, InputNode):
                    ch = self._input_channel
                elif isinstance(a, ActorMethodNode):
                    ch = self._channels[id(a)]
                elif isinstance(a, DAGNode):
                    raise ValueError(f"Unsupported arg node {type(a).__name__}")
                else:
                    arg_plan.append(("const", a))
                    continue
                if ch.name in chan_arg_idx:
                    arg_plan.append(("dup", chan_arg_idx[ch.name]))
                else:
                    chan_arg_idx[ch.name] = i
                    arg_plan.append(("chan", take_slot(ch)))
            per_actor.setdefault(id(node._target), []).append(
                (node._method_name, arg_plan, self._channels[id(node)])
            )
        self._loop_refs = [
            self._actors[aid].run_loop.remote(stages)
            for aid, stages in per_actor.items()
        ]
        # Driver takes the last reader slot of every output channel.
        self._output_channels = [
            take_slot(self._channels[id(o)]) for o in self._outputs
        ]

    # ------------------------------------------------------------- execute
    def execute(self, *args, timeout: Optional[float] = 60.0) -> "CompiledDAGRef":
        """One pipeline round. `timeout` is the default deadline for the
        returned ref's get() — the old hardcoded 60s was wrong for rounds
        that legitimately run long (training steps); pass what the round
        actually needs, or None to wait forever."""
        if self._teardown_done:
            raise RuntimeError("Compiled DAG has been torn down")
        if self._input_channel is not None:
            if len(args) != 1:
                raise ValueError("Compiled DAG execute() takes exactly one input")
            # The write can block on the PREVIOUS round's ack (depth-1
            # backpressure), so it deserves the same budget as the round.
            self._input_channel.write(args[0], timeout=timeout)
        self._execute_count += 1
        return CompiledDAGRef(self, timeout=timeout)

    def check_stage_health(self):
        """Raise if any stage exec loop has ENDED (a finished loop ref means
        teardown — or, the case worth diagnosing, the stage host died and
        its channels will never speak again). Called by CompiledDAGRef.get
        while it waits, so a SIGKILLed stage surfaces as a stage-death error
        within seconds instead of a bare channel timeout at the deadline."""
        if self._teardown_done:
            return
        done, _ = self._ray.wait(
            self._loop_refs, num_returns=len(self._loop_refs), timeout=0
        )
        for ref in done:
            try:
                self._ray.get(ref)
            except Exception as e:  # noqa: BLE001 — actor/worker death
                raise RuntimeError(
                    f"compiled DAG stage host died mid-execute: {e!r}"
                ) from e
            raise RuntimeError(
                "compiled DAG stage exec loop exited unexpectedly"
            )

    def teardown(self):
        if self._teardown_done:
            return
        self._teardown_done = True
        if self._input_channel is not None:
            self._input_channel.close_writer()
        for a in self._actors.values():
            try:
                self._ray.kill(a)
            except Exception:  # noqa: BLE001
                pass
        for c in self._all_channels:
            c.destroy()

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # noqa: BLE001
            pass


class CompiledDAGRef:
    """Result handle for one execute() round (reference returns a Channel-
    backed ref the caller begin_read/end_reads)."""

    # Health-check cadence while waiting on an output channel: a dead stage
    # is reported within this window, not at the (possibly much later) read
    # deadline.
    _HEALTH_POLL_S = 2.0

    _UNSET = object()  # get(timeout=None) must still mean "wait forever"

    def __init__(self, dag: CompiledDAG, timeout: Optional[float] = 60.0):
        self._dag = dag
        self._timeout = timeout
        self._consumed = False
        # Outputs already read by a get() attempt that later timed out on a
        # SIBLING channel — a retry must not re-read their seqs.
        self._partial: List[Any] = []

    def _read(self, ch, timeout: Optional[float]):
        """Channel read in health-check slices: a stage host dying mid-round
        leaves its output channels silent forever — surface THAT (stage
        death) instead of the bare TimeoutError the caller would otherwise
        misread as slowness."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if deadline is None:
                slice_s = self._HEALTH_POLL_S
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._dag.check_stage_health()
                    raise TimeoutError("compiled DAG output read timed out")
                slice_s = min(self._HEALTH_POLL_S, remaining)
            try:
                return ch.read(slice_s)
            except TimeoutError:
                self._dag.check_stage_health()
            except ConnectionError:
                # TCP edge: a killed stage host closes its sockets, so the
                # death arrives as a peer-closed error, not a timeout —
                # diagnose it the same way before surfacing.
                self._dag.check_stage_health()
                raise

    def get(self, timeout=_UNSET):
        """Collect this round's outputs. Omitted `timeout` uses the
        execute()-time default; an explicit value overrides it, and
        timeout=None keeps its old meaning of "wait forever". A stage
        exception raised during the round re-raises here; a dead stage host
        raises a stage-death RuntimeError. The ref is consumed only on
        success, so a timed-out get() may be retried."""
        if self._consumed:
            raise RuntimeError("CompiledDAGRef already consumed")
        timeout = self._timeout if timeout is self._UNSET else timeout
        results = self._partial
        for ch in self._dag._output_channels[len(results):]:
            try:
                results.append(self._read(ch, timeout))
            except ChannelClosed:
                self._dag.check_stage_health()
                raise
        self._consumed = True
        for r in results:
            if isinstance(r, StageError):
                r.raise_()
        single = len(results) == 1 and not isinstance(
            self._dag._outputs[0], MultiOutputNode
        )
        return results[0] if single else results


def compile_dag(node: DAGNode, *, _buffer_size_bytes: int = 1 << 20) -> CompiledDAG:
    """`dag.experimental_compile()` entry point."""
    return CompiledDAG(node, _buffer_size_bytes)
