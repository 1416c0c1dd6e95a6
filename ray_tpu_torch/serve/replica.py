"""Replica actor (reference: `serve/_private/replica.py`).

A generic actor wrapping the user's deployment callable. Requests arrive as
`handle_request(method, args, kwargs)` actor tasks — ordered execution per
replica is exactly the reference's single-asyncio-loop replica semantics.
Batched methods receive the router-formed list in one call.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ..util import tracing
from .context import (
    ReplicaContext,
    _set_multiplexed_model_id,
    _set_replica_context,
    _set_request_id,
)


class Replica:
    """NOTE: instantiated as a ray_tpu_torch actor by the controller."""

    def __init__(
        self,
        app_name: str,
        deployment_name: str,
        replica_tag: str,
        serialized_cls: bytes,
        serialized_init_args: bytes,
        user_config: Optional[dict] = None,
        role: Optional[str] = None,
    ):
        cls = cloudpickle.loads(serialized_cls)
        args, kwargs = cloudpickle.loads(serialized_init_args)
        if role:
            # Disaggregated pools: the controller assigns this replica's
            # engine role (prefill/decode) at start time — merged into the
            # `engine_options` kwarg the LLM deployment class accepts.
            # Only deployments configured with prefill_replicas > 0 ever
            # receive a role, so non-engine classes are never touched.
            kwargs = dict(kwargs)
            kwargs["engine_options"] = {
                **(kwargs.get("engine_options") or {}), "role": role,
            }
        self._role = role
        self._ctx = ReplicaContext(app_name, deployment_name, replica_tag)
        _set_replica_context(self._ctx)
        if isinstance(cls, type):
            self._callable = cls(*args, **kwargs)
            self._is_function = False
        else:
            self._callable = cls
            self._is_function = True
        self._num_processed = 0
        if user_config is not None:
            self.reconfigure(user_config)

    def reconfigure(self, user_config: dict):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    def _enter_request(self) -> str:
        """Adopt the request/trace id the executing worker inherited from
        the submitting context (the HTTP proxy or a Python caller)."""
        rid = tracing.get_trace_id() or ""
        _set_request_id(rid)
        return rid

    def _record_span(self, name: str, rid: str, method: str, t0: float):
        if not rid:
            return  # untraced call (no request context) — keep timeline lean
        try:
            tracing.record_span(
                name, t0, time.time() - t0, trace_id=rid,
                attrs={"app": self._ctx.app_name,
                       "deployment": self._ctx.deployment,
                       "replica": self._ctx.replica_tag,
                       "method": method, "request_id": rid},
            )
        except Exception:  # noqa: BLE001 — tracing is never load-bearing
            pass

    def handle_request(
        self,
        method: str,
        args: Tuple,
        kwargs: Dict,
        multiplexed_model_id: str = "",
    ) -> Any:
        _set_replica_context(self._ctx)
        _set_multiplexed_model_id(multiplexed_model_id)
        rid = self._enter_request()
        self._num_processed += 1
        t0 = time.time()
        try:
            if self._is_function:
                return self._callable(*args, **kwargs)
            return getattr(self._callable, method)(*args, **kwargs)
        finally:
            self._record_span("replica.handle", rid, method, t0)

    def handle_request_streaming(
        self,
        method: str,
        args: Tuple,
        kwargs: Dict,
        multiplexed_model_id: str = "",
    ):
        """Generator variant: yields response chunks as the user generator
        produces them (reference: Serve streaming responses /
        `handle.options(stream=True)`). Runs as a streaming actor task."""
        _set_replica_context(self._ctx)
        _set_multiplexed_model_id(multiplexed_model_id)
        rid = self._enter_request()
        self._num_processed += 1
        fn = self._callable if self._is_function else getattr(self._callable, method)
        t0 = time.time()
        out = fn(*args, **kwargs)
        import inspect

        if not inspect.isgenerator(out):
            raise TypeError(
                f"stream=True requires {method} to be a generator function"
            )
        try:
            yield from out
        finally:
            # Span covers the full drain — the generator body runs lazily.
            self._record_span("replica.handle_stream", rid, method, t0)

    def handle_batch(
        self,
        method: str,
        batched_args: List[Any],
        multiplexed_model_id: str = "",
    ) -> List[Any]:
        """Execute a router-formed batch: the user's @serve.batch method gets
        the list of single args and returns a list of results."""
        _set_replica_context(self._ctx)
        _set_multiplexed_model_id(multiplexed_model_id)
        self._num_processed += len(batched_args)
        fn = getattr(self._callable, method)
        results = fn(batched_args)
        if len(results) != len(batched_args):
            raise ValueError(
                f"@serve.batch method {method} returned {len(results)} results "
                f"for {len(batched_args)} inputs"
            )
        return results

    def ping(self) -> str:
        return "ok"

    def telemetry(self) -> Dict[str, Any]:
        """Health probe + piggybacked fleet telemetry in ONE round trip:
        the controller's reconcile loop calls this instead of `ping`, and a
        deployment exposing `fleet_state()` (the LLM engine does) ships its
        hot-prefix digest / queue depth / TTFT tail with every probe — no
        extra RPC, no extra poll loop."""
        out: Dict[str, Any] = {"ok": True, "num_processed": self._num_processed}
        fn = getattr(self._callable, "fleet_state", None)
        if fn is not None:
            try:
                out["engine"] = fn()
            except Exception:  # noqa: BLE001 — telemetry never fails health
                out["engine"] = None
        return out

    def stats(self) -> Dict[str, Any]:
        return {"num_processed": self._num_processed}
