"""Continuous-batching LLM inference engine (iteration-level scheduling over
a paged KV cache), the port of `ray_tpu/serve/engine`.

  * `kv_manager`, `scheduler`, `kv_tier`, `spec` — host-side policy, copied
    from the reference (no device code; the code is unchanged).
  * `engine` — the driver loop over `models/gpt.py`'s `prefill_paged` /
    `decode_step_paged` / `verify_step_paged` on PyTorch tensors.
  * `kv_transfer` — the span descriptor that carries computed KV blocks
    between replicas over the runtime's bulk plane (copied).
  * `deployment` — `LLMDeployment`, the engine as a Serve replica; it
    resolves lazily (it pulls in the Serve control plane).
"""

from .engine import EngineOptions, InferenceEngine, RequestOutput
from .kv_manager import KVBlockManager, KVCacheExhausted, KVStats
from .scheduler import PrefillChunk, Scheduler, SchedulerOutput, Sequence

__all__ = [
    "EngineOptions",
    "InferenceEngine",
    "KVBlockManager",
    "KVCacheExhausted",
    "KVStats",
    "PrefillChunk",
    "RequestOutput",
    "Scheduler",
    "SchedulerOutput",
    "Sequence",
    "LLMDeployment",
]


def __getattr__(name):
    if name == "LLMDeployment":
        from .deployment import LLMDeployment

        return LLMDeployment
    raise AttributeError(name)
