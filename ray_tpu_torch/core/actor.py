"""Actor API (reference: `python/ray/actor.py`).

`@remote class C` → ActorClass (`actor.py:544`); `C.remote()` → ActorHandle
(`actor.py:1192`); `handle.method.remote()` submits an ordered actor task.
Handles are serializable and can be passed to other tasks/actors.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .ids import ActorID
from .remote_function import options_from_kwargs
from .task_spec import TaskOptions


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._handle._invoke(
            self._method_name, args, kwargs, num_returns=self._num_returns
        )

    _SUPPORTED_OPTIONS = ("num_returns", "name")

    def options(self, **option_kwargs):
        num_returns = option_kwargs.pop("num_returns", self._num_returns)
        option_kwargs.pop("name", None)
        if option_kwargs:
            raise ValueError(
                f"Unsupported actor-method options {sorted(option_kwargs)}; "
                f"supported: {self._SUPPORTED_OPTIONS}"
            )
        return ActorMethod(self._handle, self._method_name, num_returns)

    def bind(self, *args, **kwargs):
        from ..dag import ActorMethodNode

        return ActorMethodNode(self._handle, self._method_name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name} cannot be called directly; use .remote()."
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str, method_num_returns: Optional[Dict[str, int]] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_num_returns = method_num_returns or {}
        self._seq_lock = threading.Lock()
        self._seq = 0

    @property
    def _id(self) -> ActorID:
        return self._actor_id

    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def _invoke(self, method_name: str, args, kwargs, num_returns: int = 1):
        from . import api

        runtime = api._global_runtime()
        opts = TaskOptions(num_returns=num_returns)
        refs = runtime.submit_actor_task(
            self._actor_id, method_name, args, kwargs, opts, self._next_seq()
        )
        if num_returns == 1:
            return refs[0]
        if num_returns == 0:
            return None
        return refs

    def __getattr__(self, item: str) -> ActorMethod:
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(
            self, item, self._method_num_returns.get(item, 1)
        )

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (
            _rebuild_handle,
            (self._actor_id, self._class_name, self._method_num_returns),
        )


def _rebuild_handle(actor_id, class_name, method_num_returns):
    return ActorHandle(actor_id, class_name, method_num_returns)


class ActorClass:
    def __init__(self, cls: type, options: TaskOptions):
        self._cls = cls
        self._default_options = options
        self.__name__ = getattr(cls, "__name__", "ActorClass")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()."
        )

    def options(self, **option_kwargs) -> "ActorClass":
        # Preserve a name/namespace set at @remote(...) time unless overridden.
        name = option_kwargs.pop("name", getattr(self, "_pending_name", None))
        namespace = option_kwargs.pop("namespace", getattr(self, "_pending_namespace", None))
        new = ActorClass(self._cls, options_from_kwargs(self._default_options, **option_kwargs))
        new._pending_name = name
        new._pending_namespace = namespace
        return new

    def remote(self, *args, **kwargs) -> ActorHandle:
        from . import api

        runtime = api._global_runtime()
        name = getattr(self, "_pending_name", None) or ""
        namespace = getattr(self, "_pending_namespace", None) or "default"
        if name and self._default_options.get_if_exists:
            existing = api.get_actor_or_none(name, namespace)
            if existing is not None:
                return existing
        # Collect per-method num_returns declared via @method(num_returns=N) up
        # front so named-actor lookups reconstruct an identical handle.
        method_num_returns = {}
        for attr_name in dir(self._cls):
            attr = getattr(self._cls, attr_name, None)
            n = getattr(attr, "__ray_tpu_num_returns__", None)
            if n is not None:
                method_num_returns[attr_name] = n
        actor_id = runtime.create_actor(
            self._cls,
            args,
            kwargs,
            self._default_options,
            name,
            namespace,
            method_meta=method_num_returns,
        )
        return ActorHandle(actor_id, self.__name__, method_num_returns)

    def bind(self, *args, **kwargs):
        from ..dag import ClassNode

        return ClassNode(self, args, kwargs)

    @property
    def cls(self) -> type:
        return self._cls


def method(num_returns: int = 1):
    """Decorator marking per-method options (reference: `ray.method`)."""

    def decorator(fn):
        fn.__ray_tpu_num_returns__ = num_returns
        return fn

    return decorator
