"""Deployment + Application graph (reference: `python/ray/serve/deployment.py`,
`api.py:449 serve.run`, deployment graphs via `deployment_graph_build.py`).

`@serve.deployment class D` → Deployment; `D.bind(args)` → Application node.
Binding another Application as an init arg builds a multi-deployment graph:
the child is deployed separately and the parent receives a DeploymentHandle
in its place (the reference's deployment-graph build pass).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    """Reference: `serve/_private/autoscaling_policy.py` knobs, extended
    with the engine-metrics signals (`serve/fleet/autoscale.py`): scale-up
    also fires on per-replica engine queue depth or the TTFT tail, and
    scale-down additionally requires the coldest replica's recent
    prefix-hit rate to be below `downscale_hit_rate` (a hot cache is
    cheaper to keep than to re-warm)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    # Engine-metrics signals (ignored for deployments without an engine).
    target_queue_depth: float = 4.0
    ttft_p99_target_s: Optional[float] = None
    downscale_hit_rate: float = 0.2


@dataclasses.dataclass
class DeploymentOptions:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    user_config: Optional[dict] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    health_check_period_s: float = 10.0
    # How long a replica may sit in __init__ (model load + jit compile)
    # before the controller gives up and replaces it. LLM replicas
    # legitimately take minutes.
    replica_startup_timeout_s: float = 600.0
    max_num_models_per_replica: int = 3  # multiplexing LRU size
    # Fleet routing: steer requests to the replica whose hot-prefix digest
    # matches the prompt's leading KV blocks (serve/fleet/routing.py).
    # False = plain power-of-two (the bench baseline).
    prefix_affinity_routing: bool = True
    # Disaggregated prefill/decode serving (serve/README.md): > 0 splits
    # the replica set into a prefill pool of this size (engines started
    # with role="prefill") and a decode pool (role="decode", the rest).
    # The router then orchestrates prefill->handoff->decode per request,
    # shipping computed KV between pools over the bulk plane, and the
    # controller autoscales the two pools on their own signals (TTFT tail
    # -> prefill, queue/in-flight -> decode). 0 = colocated (default).
    prefill_replicas: int = 0


class Deployment:
    def __init__(self, cls_or_fn: Callable, name: str, options: DeploymentOptions):
        self._callable = cls_or_fn
        self._is_function = not isinstance(cls_or_fn, type)
        self.name = name
        self.opts = options

    def options(self, **kwargs) -> "Deployment":
        new_opts = dataclasses.replace(self.opts)
        for k, v in kwargs.items():
            if k == "autoscaling_config" and isinstance(v, dict):
                v = AutoscalingConfig(**v)
            if not hasattr(new_opts, k):
                raise ValueError(f"Unknown deployment option {k!r}")
            setattr(new_opts, k, v)
        return Deployment(self._callable, self.name, new_opts)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name})"


class Application:
    """A bound deployment node; may reference other Applications in args."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs

    def _flatten(self) -> List["Application"]:
        """Topological list of all apps in this graph, dependencies first."""
        seen: List[Application] = []

        def visit(app: Application):
            for a in list(app.init_args) + list(app.init_kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            if app not in seen:
                seen.append(app)

        visit(self)
        return seen


def deployment(
    _cls: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Optional[int] = None,
    max_ongoing_requests: Optional[int] = None,
    user_config: Optional[dict] = None,
    autoscaling_config: Optional[dict] = None,
    ray_actor_options: Optional[dict] = None,
    replica_startup_timeout_s: Optional[float] = None,
):
    """`@serve.deployment` decorator (reference: `serve/api.py` `deployment`)."""

    def wrap(cls):
        opts = DeploymentOptions()
        if num_replicas is not None:
            opts.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            opts.max_ongoing_requests = max_ongoing_requests
        if user_config is not None:
            opts.user_config = user_config
        if autoscaling_config is not None:
            opts.autoscaling_config = (
                autoscaling_config
                if isinstance(autoscaling_config, AutoscalingConfig)
                else AutoscalingConfig(**autoscaling_config)
            )
        if ray_actor_options is not None:
            opts.ray_actor_options = dict(ray_actor_options)
        if replica_startup_timeout_s is not None:
            opts.replica_startup_timeout_s = float(replica_startup_timeout_s)
        return Deployment(cls, name or cls.__name__, opts)

    if _cls is not None:
        return wrap(_cls)
    return wrap
