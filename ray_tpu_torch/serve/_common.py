"""Shared ingress helpers (HTTP + gRPC proxies)."""

from __future__ import annotations

import json


def response_bytes(value) -> bytes:
    """Response packing rule shared by every ingress: bytes passthrough,
    str utf-8, anything else JSON."""
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode()
    return json.dumps(value).encode()
