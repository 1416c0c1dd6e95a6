"""gRPC ingress for Serve.

Reference analog: Serve's gRPCProxy (`serve/_private/proxy.py:556`) over
`serve.proto`. Contract: `ray_tpu_torch.serve.RayTpuServe/Predict` (unary) and
`/PredictStream` (server streaming) carrying `ServeRequest`/`ServeReply`
(`ray_tpu_torch/protocol/serve.proto`). Service wiring is a
`grpc.GenericRpcHandler` — no generated service stubs needed.

The deployment receives a `GRPCRequest` (payload bytes + method +
model id); whatever it returns is packed back into `ServeReply.payload`
(bytes passthrough, str utf-8, else JSON).
"""

from __future__ import annotations

import json
import time
from concurrent import futures
from typing import Optional

from ._common import response_bytes as _as_bytes

SERVICE = "ray_tpu_torch.serve.RayTpuServe"


class GRPCRequest:
    """What a deployment's method receives for gRPC traffic."""

    def __init__(self, payload: bytes, method: str, multiplexed_model_id: str):
        self.payload = payload
        self.method = method
        self.multiplexed_model_id = multiplexed_model_id

    def json(self):
        return json.loads(self.payload or b"null")

    def text(self) -> str:
        return (self.payload or b"").decode()


class GRPCProxy:
    """NOTE: instantiated as a ray_tpu_torch actor by `serve.start(grpc_options=...)`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import grpc

        from ..protocol import serve_pb2

        proxy = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                if method == f"/{SERVICE}/Predict":
                    return grpc.unary_unary_rpc_method_handler(
                        proxy._predict,
                        request_deserializer=serve_pb2.ServeRequest.FromString,
                        response_serializer=serve_pb2.ServeReply.SerializeToString,
                    )
                if method == f"/{SERVICE}/PredictStream":
                    return grpc.unary_stream_rpc_method_handler(
                        proxy._predict_stream,
                        request_deserializer=serve_pb2.ServeRequest.FromString,
                        response_serializer=serve_pb2.ServeReply.SerializeToString,
                    )
                return None

        self._pb = serve_pb2
        self._grpc = grpc
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
        self._server.add_generic_rpc_handlers((Handler(),))
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    def get_port(self) -> int:
        return self._port

    def ping(self) -> str:
        return "ok"

    # ------------------------------------------------------------ handlers
    def _apps(self):
        """Name-addressed app map with a 1s TTL cache (same pattern as the
        HTTP proxy's route cache — two controller RPCs per request would
        make the controller the ingress bottleneck)."""
        import ray_tpu_torch
        from .controller import CONTROLLER_NAME, SERVE_NAMESPACE

        now = time.monotonic()
        cached = getattr(self, "_apps_cache", None)
        if cached is not None and now - self._apps_cached_at < 1.0:
            return cached
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        self._apps_cache = ray_tpu_torch.get(controller.app_snapshot.remote())
        self._apps_cached_at = now
        return self._apps_cache

    def _resolve(self, request, context):
        from .handle import DeploymentHandle

        apps = self._apps()
        app = request.app or "default"
        match = apps.get(app)
        if match is None:
            # One forced refresh: the app may have deployed inside the TTL.
            self._apps_cached_at = 0.0
            match = self._apps().get(app)
        if match is None:
            context.abort(
                self._grpc.StatusCode.NOT_FOUND,
                f"no Serve application {app!r}",
            )
        handle = DeploymentHandle(app, match["ingress"])
        req = GRPCRequest(
            request.payload, request.method, request.multiplexed_model_id
        )
        if request.multiplexed_model_id:
            handle = handle.options(
                multiplexed_model_id=request.multiplexed_model_id
            )
        return handle, req, match

    def _predict(self, request, context):
        handle, req, _ = self._resolve(request, context)
        if request.method:
            result = getattr(handle, request.method).remote(req).result(timeout_s=60.0)
        else:
            result = handle.remote(req).result(timeout_s=60.0)
        return self._pb.ServeReply(payload=_as_bytes(result))

    def _predict_stream(self, request, context):
        handle, req, _ = self._resolve(request, context)
        stream_handle = handle.options(stream=True)
        gen = (
            getattr(stream_handle, request.method).remote(req)
            if request.method
            else stream_handle.remote(req)
        )
        for chunk in gen:
            yield self._pb.ServeReply(payload=_as_bytes(chunk))

    def shutdown(self):
        self._server.stop(grace=0.5)
