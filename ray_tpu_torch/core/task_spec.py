"""TaskSpec / ActorSpec — the unit of work handed to the scheduler.

Python-dataclass analog of the reference's `TaskSpecification`
(`src/ray/protobuf/common.proto:398+`, `src/ray/common/task/task_spec.h`):
function payload, ids, args (inline values or ObjectRefs), resource demand,
scheduling strategy, retry policy, and streaming-generator flags.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, JobID, ObjectID, TaskID


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


@dataclass
class SchedulingStrategy:
    """Base for scheduling strategies (reference: `util/scheduling_strategies.py`)."""


@dataclass
class DefaultSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class SpreadSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    node_id: str = ""
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy(SchedulingStrategy):
    """Schedule only onto nodes whose labels match `hard` exactly
    (reference: `NodeLabelSchedulingStrategy`, `node_label_scheduling_policy.h`
    — hard equality constraints; soft preferences are a non-goal here)."""

    hard: Dict[str, str] = field(default_factory=dict)


@dataclass
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class TaskOptions:
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    num_tpus: Optional[float] = None
    resources: Dict[str, float] = field(default_factory=dict)
    num_returns: int = 1
    max_retries: int = 3
    retry_exceptions: bool | list = False
    name: str = ""
    scheduling_strategy: Optional[SchedulingStrategy] = None
    runtime_env: Optional[dict] = None
    # Actor-only options.
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    lifetime: Optional[str] = None  # None | "detached"
    namespace: Optional[str] = None
    get_if_exists: bool = False

    def __post_init__(self):
        # -1 is the ONE canonical streaming sentinel (what the proto wire
        # carries) — normalizing here means no consumer ever has to handle
        # the "streaming"/"dynamic" string forms past construction.
        if self.num_returns in ("streaming", "dynamic"):
            self.num_returns = -1

    def resource_demand(self, default_num_cpus: float) -> Dict[str, float]:
        demand = dict(self.resources)
        cpus = self.num_cpus if self.num_cpus is not None else default_num_cpus
        if cpus:
            demand["CPU"] = float(cpus)
        if self.num_gpus:
            demand["GPU"] = float(self.num_gpus)
        if self.num_tpus:
            demand["TPU"] = float(self.num_tpus)
        return demand


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    # Serialized (function, args, kwargs) payload; refs listed separately so the
    # scheduler can resolve dependencies before dispatch.
    func_payload: bytes
    arg_refs: List[ObjectID]
    num_returns: int
    return_ids: List[ObjectID]
    resources: Dict[str, float]
    options: TaskOptions
    name: str = ""
    # Actor fields.
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    sequence_number: int = 0
    # Per-method metadata (e.g. num_returns from @method) so named-actor
    # lookups can reconstruct a full-fidelity handle.
    method_meta: Dict[str, int] = field(default_factory=dict)
    # Retry bookkeeping.
    attempt_number: int = 0
    # Owner (submitter) address for result routing.
    owner_address: str = ""
    depth: int = 0
    # Causality: the task (or driver task) that submitted this one —
    # reference analog: `parent_task_id` in common.proto's TaskSpec; drives
    # the tracing span tree (`ray_tpu_torch/util/tracing.py`).
    parent_task_id: Optional[TaskID] = None
    # Dapper-style trace id inherited from the submitting context (empty =
    # this task roots its own trace); `util/tracing.py` keys span forests
    # and the Serve request path by it.
    trace_id: str = ""


# ------------------------------------------------------ typed wire contract
# Reference analog: `src/ray/protobuf/common.proto` TaskSpec — the schema
# every component shares. Structure (ids, resources, scheduling, retries)
# is protobuf; Python-object payloads stay opaque bytes.
@dataclass
class _PGRef:
    """Lightweight stand-in for a PlacementGroup handle on the wire: the
    scheduler only needs its id (and the strategy's bundle index)."""

    id: Any


def _strategy_to_proto(pb, strat: Optional[SchedulingStrategy]):
    msg = pb.SchedulingStrategy()
    if strat is None or isinstance(strat, DefaultSchedulingStrategy):
        msg.default = True
    elif isinstance(strat, SpreadSchedulingStrategy):
        msg.spread = True
    elif isinstance(strat, NodeAffinitySchedulingStrategy):
        msg.node_affinity.node_id = strat.node_id
        msg.node_affinity.soft = strat.soft
    elif isinstance(strat, NodeLabelSchedulingStrategy):
        for k, v in strat.hard.items():
            msg.node_labels.hard[k] = str(v)
    elif isinstance(strat, PlacementGroupSchedulingStrategy):
        pg = strat.placement_group
        pg_id = getattr(pg, "id", None)
        msg.placement_group.placement_group_id = (
            pg_id.binary() if pg_id is not None else b""
        )
        msg.placement_group.bundle_index = strat.placement_group_bundle_index
        msg.placement_group.capture_child_tasks = (
            strat.placement_group_capture_child_tasks
        )
    else:
        raise TypeError(f"unknown scheduling strategy {type(strat).__name__}")
    return msg


def _strategy_from_proto(msg) -> Optional[SchedulingStrategy]:
    kind = msg.WhichOneof("strategy")
    if kind is None or kind == "default":
        return None
    if kind == "spread":
        return SpreadSchedulingStrategy()
    if kind == "node_affinity":
        return NodeAffinitySchedulingStrategy(
            node_id=msg.node_affinity.node_id, soft=msg.node_affinity.soft
        )
    if kind == "node_labels":
        return NodeLabelSchedulingStrategy(hard=dict(msg.node_labels.hard))
    from .ids import PlacementGroupID

    pg_bytes = msg.placement_group.placement_group_id
    return PlacementGroupSchedulingStrategy(
        placement_group=_PGRef(PlacementGroupID(pg_bytes)) if pg_bytes else None,
        placement_group_bundle_index=msg.placement_group.bundle_index,
        placement_group_capture_child_tasks=msg.placement_group.capture_child_tasks,
    )


def spec_to_proto_bytes(spec: TaskSpec) -> bytes:
    import cloudpickle

    from ..protocol import ray_tpu_pb2 as pb

    msg = pb.TaskSpec()
    msg.task_id = spec.task_id.binary()
    msg.job_id = spec.job_id.binary()
    msg.task_type = spec.task_type.value
    msg.func_payload = spec.func_payload or b""
    for oid in spec.arg_refs:
        msg.arg_refs.append(oid.binary())
    msg.num_returns = spec.num_returns
    for oid in spec.return_ids:
        msg.return_ids.append(oid.binary())
    for k, v in spec.resources.items():
        msg.resources[k] = float(v)
    o, po = spec.options, msg.options
    if o.num_cpus is not None:
        po.num_cpus = o.num_cpus
    if o.num_gpus is not None:
        po.num_gpus = o.num_gpus
    if o.num_tpus is not None:
        po.num_tpus = o.num_tpus
    for k, v in o.resources.items():
        po.resources[k] = float(v)
    po.num_returns = int(o.num_returns)  # -1 sentinel since __post_init__
    po.max_retries = o.max_retries
    if isinstance(o.retry_exceptions, (list, tuple)):
        po.retry_exceptions = True
        po.retry_exception_allowlist = cloudpickle.dumps(list(o.retry_exceptions))
    else:
        po.retry_exceptions = bool(o.retry_exceptions)
    po.name = o.name or ""
    po.scheduling_strategy.CopyFrom(_strategy_to_proto(pb, o.scheduling_strategy))
    if o.runtime_env:
        po.runtime_env = cloudpickle.dumps(o.runtime_env)
    po.max_restarts = o.max_restarts
    po.max_task_retries = o.max_task_retries
    po.max_concurrency = o.max_concurrency
    po.lifetime = o.lifetime or ""
    po.namespace = o.namespace or ""
    po.get_if_exists = o.get_if_exists
    msg.name = spec.name
    if spec.actor_id is not None:
        msg.actor_id = spec.actor_id.binary()
    msg.method_name = spec.method_name
    msg.sequence_number = spec.sequence_number
    for k, v in spec.method_meta.items():
        msg.method_meta[k] = -1 if v in ("streaming", "dynamic") else int(v)
    msg.attempt_number = spec.attempt_number
    msg.owner_address = spec.owner_address
    msg.depth = spec.depth
    if spec.parent_task_id is not None:
        msg.parent_task_id = spec.parent_task_id.binary()
    if spec.trace_id:
        msg.trace_id = spec.trace_id
    return msg.SerializeToString()


def spec_from_proto_bytes(data: bytes) -> TaskSpec:
    import cloudpickle

    from ..protocol import ray_tpu_pb2 as pb

    msg = pb.TaskSpec()
    msg.ParseFromString(data)
    po = msg.options
    if po.retry_exception_allowlist:
        retry_exceptions: Any = cloudpickle.loads(po.retry_exception_allowlist)
    else:
        retry_exceptions = po.retry_exceptions
    options = TaskOptions(
        num_cpus=po.num_cpus if po.HasField("num_cpus") else None,
        num_gpus=po.num_gpus if po.HasField("num_gpus") else None,
        num_tpus=po.num_tpus if po.HasField("num_tpus") else None,
        resources=dict(po.resources),
        num_returns=po.num_returns,
        max_retries=po.max_retries,
        retry_exceptions=retry_exceptions,
        name=po.name,
        scheduling_strategy=_strategy_from_proto(po.scheduling_strategy),
        runtime_env=cloudpickle.loads(po.runtime_env) if po.runtime_env else None,
        max_restarts=po.max_restarts,
        max_task_retries=po.max_task_retries,
        max_concurrency=po.max_concurrency,
        lifetime=po.lifetime or None,
        namespace=po.namespace or None,
        get_if_exists=po.get_if_exists,
    )
    return TaskSpec(
        task_id=TaskID(msg.task_id),
        job_id=JobID(msg.job_id),
        task_type=TaskType(msg.task_type),
        func_payload=msg.func_payload,
        arg_refs=[ObjectID(b) for b in msg.arg_refs],
        num_returns=msg.num_returns,
        return_ids=[ObjectID(b) for b in msg.return_ids],
        resources=dict(msg.resources),
        options=options,
        name=msg.name,
        actor_id=ActorID(msg.actor_id) if msg.actor_id else None,
        method_name=msg.method_name,
        sequence_number=msg.sequence_number,
        method_meta=dict(msg.method_meta),
        attempt_number=msg.attempt_number,
        owner_address=msg.owner_address,
        depth=msg.depth,
        parent_task_id=TaskID(msg.parent_task_id) if msg.parent_task_id else None,
        trace_id=msg.trace_id,
    )
