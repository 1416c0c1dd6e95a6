"""HTTP proxy actor (reference: `serve/_private/proxy.py:773,1313`).

A ThreadingHTTPServer inside an actor: each HTTP request resolves the route
prefix against the controller's routing snapshot and forwards to the app's
ingress deployment through a DeploymentHandle (same data plane as Python
callers). The reference runs uvicorn; requests here carry a simple `Request`
object with method/path/query/body accessors.
"""

from __future__ import annotations

import itertools
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


from ..util import tracing
from ._common import response_bytes as _as_bytes


class Request:
    """What ingress `__call__` receives for HTTP traffic."""

    def __init__(self, method: str, path: str, query: dict, body: bytes, headers: dict):
        self.method = method
        self.path = path
        self.query_params = query
        self.body = body
        self.headers = headers

    def json(self):
        return json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()


class HTTPProxy:
    """NOTE: instantiated as a ray_tpu_torch actor by `serve.start`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._routes = {}
        self._routes_version = -1
        self._routes_refreshed = 0.0
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence per-request stderr noise
                pass

            def _serve(self):
                # One request id per HTTP request; it IS the trace id every
                # downstream hop inherits (handle → replica → engine), so
                # `/api/traces?trace_id=<x-request-id>` shows the whole path.
                rid = tracing.new_trace_id()
                self.request_id = rid
                t0 = time.time()
                status = 500
                try:
                    tracing.set_trace_id(rid)
                except Exception:  # noqa: BLE001 — runtime still booting
                    pass
                try:
                    status, _ = self._serve_traced()
                finally:
                    try:
                        tracing.record_span(
                            "proxy.request", t0, time.time() - t0,
                            trace_id=rid,
                            attrs={"method": self.command, "path": self.path,
                                   "status": status, "request_id": rid},
                        )
                        tracing.set_trace_id(None)
                    except Exception:  # noqa: BLE001
                        pass

            def _serve_traced(self):
                try:
                    status, payload = proxy._handle(self)
                except Exception as e:  # noqa: BLE001
                    status, payload = 500, json.dumps({"error": repr(e)}).encode()
                if callable(payload):
                    # Streaming route: chunked transfer, flushed per chunk as
                    # the replica's generator yields (reference: Serve
                    # StreamingResponse over ASGI). Pull the FIRST chunk
                    # before committing status so a failing generator still
                    # gets a proper 500.
                    it = iter(payload())
                    try:
                        first = next(it, None)
                    except Exception as e:  # noqa: BLE001
                        err = json.dumps({"error": repr(e)}).encode()
                        self.send_response(500)
                        self.send_header("Content-Length", str(len(err)))
                        self.send_header("Content-Type", "application/json")
                        self.send_header("x-request-id", self.request_id)
                        self.end_headers()
                        self.wfile.write(err)
                        return 500, None
                    self.send_response(status)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("x-request-id", self.request_id)
                    self.end_headers()
                    try:
                        chunks = (
                            iter(())
                            if first is None
                            else itertools.chain((first,), it)
                        )
                        for chunk in chunks:
                            data = _as_bytes(chunk)
                            self.wfile.write(
                                f"{len(data):X}\r\n".encode() + data + b"\r\n"
                            )
                            self.wfile.flush()
                        self.wfile.write(b"0\r\n\r\n")
                    except BrokenPipeError:
                        self.close_connection = True
                    except Exception:  # noqa: BLE001 — mid-stream failure:
                        # abort the chunked body AND close the socket (like
                        # ASGI servers) so the client unblocks; a kept-alive
                        # connection would leave it waiting mid-body forever.
                        self.close_connection = True
                    return status, None
                self.send_response(status)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Content-Type", "application/json")
                self.send_header("x-request-id", self.request_id)
                self.end_headers()
                self.wfile.write(payload)
                return status, None

            do_GET = do_POST = do_PUT = do_DELETE = _serve

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def get_port(self) -> int:
        return self._port

    def ping(self) -> str:
        return "ok"

    def _refresh_routes(self):
        import ray_tpu_torch
        from .controller import CONTROLLER_NAME, SERVE_NAMESPACE

        now = time.monotonic()
        if now - self._routes_refreshed < 1.0 and self._routes:
            return
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        self._routes = ray_tpu_torch.get(controller.routing_snapshot.remote())
        self._routes_refreshed = now

    def _handle(self, h: BaseHTTPRequestHandler):
        from .handle import DeploymentHandle

        # Drain the body FIRST — an early return with unread body bytes
        # corrupts the next request on a keep-alive connection.
        length = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(length) if length else b""

        self._refresh_routes()
        parsed = urlparse(h.path)
        path = parsed.path
        match: Optional[str] = None
        for prefix in sorted(self._routes, key=len, reverse=True):
            if path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/":
                match = prefix
                break
        if match is None:
            return 404, json.dumps({"error": f"no route for {path}"}).encode()
        route = self._routes[match]
        req = Request(
            method=h.command,
            path=path[len(match.rstrip("/")):] or "/",
            query={k: v[0] if len(v) == 1 else v for k, v in parse_qs(parsed.query).items()},
            body=body,
            headers=dict(h.headers),
        )
        if route.get("streaming"):
            handle = DeploymentHandle(route["app"], route["ingress"], stream=True)
            gen = handle.remote(req)
            return 200, lambda: iter(gen)

        handle = DeploymentHandle(route["app"], route["ingress"])
        result = handle.remote(req).result(timeout_s=60.0)

        if isinstance(result, bytes):
            return 200, result
        if isinstance(result, str):
            return 200, result.encode()
        return 200, json.dumps(result).encode()

    def shutdown(self):
        self._server.shutdown()
