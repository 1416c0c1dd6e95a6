"""Autoscaler SDK — `request_resources` (reference:
`python/ray/autoscaler/sdk/__init__.py` → GCS resource_request)."""

from __future__ import annotations

from typing import Dict, List, Optional


def request_resources(
    num_cpus: Optional[int] = None,
    bundles: Optional[List[Dict[str, float]]] = None,
):
    """Pin a capacity floor the autoscaler will scale to regardless of queued
    work. Call with no arguments to clear the request."""
    from ..core import api

    demand: List[Dict[str, float]] = list(bundles or [])
    if num_cpus:
        demand.extend({"CPU": 1.0} for _ in range(int(num_cpus)))
    backend = api._global_runtime().backend
    if not hasattr(backend, "_request"):
        raise RuntimeError(
            "request_resources needs a cluster backend; "
            "init with an address (cluster mode) first."
        )
    backend._request({"type": "request_resources", "bundles": demand})
