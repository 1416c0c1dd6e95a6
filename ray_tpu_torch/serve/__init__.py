"""ray_tpu_torch.serve — online model serving (reference: `python/ray/serve/`).

Control plane: ServeController actor reconciling deployment → replica-actor
state, with engine-metrics autoscaling (`fleet/autoscale.py`). Data plane:
client-side Router (prefix-affinity placement for LLM prompts via
`fleet/routing.py`, power-of-two-choices otherwise) → replica actors;
batch formation in the router so TPU replicas run one XLA program per
formed batch. See SURVEY.md §2.5 / §3.4 and README.md "Fleet serving".
"""

from .api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    grpc_port,
    http_port,
    run,
    run_config,
    shutdown,
    start,
    status,
)
from .batching import batch, multiplexed
from .context import get_multiplexed_model_id, get_replica_context
from .deployment import Application, AutoscalingConfig, Deployment, deployment
from .handle import DeploymentHandle, DeploymentResponse, DeploymentResponseGenerator
from .http_proxy import Request

__all__ = [
    "deployment",
    "Deployment",
    "Application",
    "AutoscalingConfig",
    "run",
    "run_config",
    "start",
    "delete",
    "status",
    "shutdown",
    "http_port",
    "batch",
    "multiplexed",
    "get_multiplexed_model_id",
    "get_replica_context",
    "DeploymentHandle",
    "DeploymentResponse",
    "grpc_port",
    "DeploymentResponseGenerator",
    "Request",
]


# Continuous-batching LLM engine (serve.engine) — lazy: LLMDeployment pulls
# in JAX + the model stack, which plain control-plane users never need.
_ENGINE_EXPORTS = frozenset(
    {"LLMDeployment", "InferenceEngine", "EngineOptions", "KVBlockManager"}
)
__all__ += ["LLMDeployment", "InferenceEngine", "EngineOptions", "KVBlockManager"]


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from . import engine as _engine

        return getattr(_engine, name)
    raise AttributeError(name)


def ingress(*_a, **_k):
    """FastAPI-style ingress decorator is a no-op shim (no fastapi in the
    image); plain `__call__(request)` deployments cover HTTP ingress."""

    def wrap(cls):
        return cls

    return wrap
