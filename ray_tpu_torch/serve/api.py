"""serve public API (reference: `python/ray/serve/api.py`: `start`, `run:449`,
`delete`, `status`, `shutdown`, `get_app_handle`, `get_deployment_handle`)."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import cloudpickle

from .controller import CONTROLLER_NAME, SERVE_NAMESPACE, ServeController
from .deployment import Application, AutoscalingConfig, Deployment
from .handle import DeploymentHandle, Router

_http_proxy = None
_grpc_proxy = None


def _ensure_ray():
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(ignore_reinit_error=True)
    return ray_tpu_torch


def _get_controller(create: bool = True):
    ray = _ensure_ray()
    handle = ray.get_actor_or_none(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    if handle is None and create:
        handle = (
            ray.remote(ServeController)
            .options(name=CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
            .remote()
        )
        ray.get(handle.ping.remote())
    return handle


def start(
    detached: bool = True,
    http_options: Optional[dict] = None,
    grpc_options: Optional[dict] = None,
    **_compat,
):
    """Start the Serve control plane (+ HTTP / gRPC proxies if configured)."""
    global _http_proxy, _grpc_proxy
    ray = _ensure_ray()
    _get_controller()
    if http_options and _http_proxy is None:
        from .http_proxy import HTTPProxy

        _http_proxy = ray.remote(HTTPProxy).remote(
            http_options.get("host", "127.0.0.1"), http_options.get("port", 0)
        )
        ray.get(_http_proxy.ping.remote())
    if grpc_options and _grpc_proxy is None:
        from .grpc_proxy import GRPCProxy

        _grpc_proxy = ray.remote(GRPCProxy).remote(
            grpc_options.get("host", "127.0.0.1"), grpc_options.get("port", 0)
        )
        ray.get(_grpc_proxy.ping.remote())
    return _http_proxy


def http_port() -> Optional[int]:
    ray = _ensure_ray()
    if _http_proxy is None:
        return None
    return ray.get(_http_proxy.get_port.remote())


def grpc_port() -> Optional[int]:
    ray = _ensure_ray()
    if _grpc_proxy is None:
        return None
    return ray.get(_grpc_proxy.get_port.remote())


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: str = "/",
    _blocking: bool = True,
    timeout_s: float = 60.0,
) -> DeploymentHandle:
    import dataclasses

    ray = _ensure_ray()
    controller = _get_controller()

    apps = app._flatten()
    specs = []
    for a in apps:
        dep: Deployment = a.deployment
        init_args = tuple(
            DeploymentHandle(name, x.deployment.name) if isinstance(x, Application) else x
            for x in a.init_args
        )
        init_kwargs = {
            k: DeploymentHandle(name, v.deployment.name) if isinstance(v, Application) else v
            for k, v in a.init_kwargs.items()
        }
        opts = dataclasses.asdict(dep.opts)
        batch_methods = {}
        if isinstance(dep._callable, type):
            for mname in dir(dep._callable):
                m = getattr(dep._callable, mname, None)
                cfg = getattr(m, "_serve_batch_config", None)
                if cfg is not None:
                    batch_methods[mname] = {
                        "max_batch_size": cfg.max_batch_size,
                        "batch_wait_timeout_s": cfg.batch_wait_timeout_s,
                    }
        specs.append(
            {
                "name": dep.name,
                "cls": cloudpickle.dumps(dep._callable),
                "init_args": cloudpickle.dumps((init_args, init_kwargs)),
                "opts": opts,
                "batch_methods": batch_methods,
            }
        )

    ingress_name = app.deployment.name
    # Streaming ingress: a generator-function __call__ makes the HTTP proxy
    # stream chunks as they are produced (reference: Serve StreamingResponse).
    import inspect as _inspect

    ingress_callable = app.deployment._callable
    ingress_fn = (
        getattr(ingress_callable, "__call__", None)
        if isinstance(ingress_callable, type)
        else ingress_callable
    )
    ingress_streaming = bool(
        ingress_fn is not None and _inspect.isgeneratorfunction(ingress_fn)
    )
    ray.get(
        controller.deploy_application.remote(
            name, specs, route_prefix, ingress_name, ingress_streaming
        )
    )
    if _blocking:
        _wait_healthy(name, timeout_s)
    # Invalidate any cached routers for this app (replica sets changed).
    with Router._routers_lock:
        for key in list(Router._routers):
            if key[0] == name:
                del Router._routers[key]
    return DeploymentHandle(name, ingress_name)


def _wait_healthy(app_name: str, timeout_s: float):
    ray = _ensure_ray()
    controller = _get_controller()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = ray.get(controller.status.remote())
        app = st.get(app_name)
        if app and app["status"] == "RUNNING":
            return
        time.sleep(0.1)
    raise TimeoutError(f"Application {app_name} failed to become RUNNING in {timeout_s}s")


def run_config(config: dict) -> Dict[str, DeploymentHandle]:
    """Deploy applications from a declarative config (reference: Serve's
    REST schema `serve/schema.py` + `serve deploy config.yaml`).

    Schema:
        {"http_options": {"host": ..., "port": ...},           # optional
         "applications": [
             {"name": "app", "route_prefix": "/",
              "import_path": "my_module:app",                  # Application
              "deployments": [                                 # overrides
                  {"name": "Model", "num_replicas": 2,
                   "user_config": {...}}]}]}
    """
    import importlib

    from .deployment import Application

    if config.get("http_options"):
        start(http_options=config["http_options"])
    handles: Dict[str, DeploymentHandle] = {}
    for app_cfg in config.get("applications", []):
        mod_name, _, attr = app_cfg["import_path"].partition(":")
        target = getattr(importlib.import_module(mod_name), attr)
        app = target() if callable(target) and not isinstance(target, Application) else target
        if not isinstance(app, Application):
            raise TypeError(
                f"{app_cfg['import_path']} is not a bound Application "
                "(expected `deployment.bind(...)` or a zero-arg builder)"
            )
        overrides = {d["name"]: d for d in app_cfg.get("deployments", [])}
        # Apply overrides to the (module-cached) graph, deploy, then RESTORE:
        # a later run_config without the override must see the code defaults,
        # not this config's leftovers.
        originals = [(node, node.deployment) for node in app._flatten()]
        try:
            for node, dep in originals:
                o = overrides.get(dep.name)
                if o:
                    node.deployment = dep.options(
                        **{k: v for k, v in o.items() if k != "name"}
                    )
            name = app_cfg.get("name", "default")
            handles[name] = run(
                app,
                name=name,
                route_prefix=app_cfg.get("route_prefix", "/"),
            )
        finally:
            for node, dep in originals:
                node.deployment = dep
    return handles


def delete(name: str, _blocking: bool = True):
    ray = _ensure_ray()
    controller = _get_controller(create=False)
    if controller is not None:
        ray.get(controller.delete_application.remote(name))


def status() -> Dict[str, Any]:
    ray = _ensure_ray()
    controller = _get_controller(create=False)
    if controller is None:
        return {"applications": {}}
    return {"applications": ray.get(controller.status.remote())}


def get_app_handle(name: str) -> DeploymentHandle:
    ray = _ensure_ray()
    controller = _get_controller(create=False)
    if controller is None:
        raise RuntimeError("Serve is not running")
    st = ray.get(controller.status.remote())
    if name not in st:
        raise ValueError(f"Application {name} not found")
    ingress = ray.get(controller.routing_snapshot.remote())
    # Find ingress by matching app name in snapshot, else ask status.
    for route, info in ingress.items():
        if info["app"] == name:
            return DeploymentHandle(name, info["ingress"])
    raise ValueError(f"Application {name} has no ingress")


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name, deployment_name)


def shutdown():
    """Tear down all applications, the controller and proxies."""
    global _http_proxy, _grpc_proxy
    ray = _ensure_ray()
    controller = _get_controller(create=False)
    if controller is not None:
        try:
            ray.get(controller.shutdown.remote())
            ray.kill(controller)
        except Exception:  # noqa: BLE001
            pass
    if _http_proxy is not None:
        try:
            ray.get(_http_proxy.shutdown.remote())
            ray.kill(_http_proxy)
        except Exception:  # noqa: BLE001
            pass
        _http_proxy = None
    if _grpc_proxy is not None:
        try:
            ray.get(_grpc_proxy.shutdown.remote())
            ray.kill(_grpc_proxy)
        except Exception:  # noqa: BLE001
            pass
        _grpc_proxy = None
    with Router._routers_lock:
        Router._routers.clear()
