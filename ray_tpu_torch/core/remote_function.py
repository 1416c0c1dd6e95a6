"""@remote functions (reference: `python/ray/remote_function.py`).

`f.remote(*args)` builds a TaskSpec and submits it (reference `_remote`
`remote_function.py:262` → `submit_task` `:428`); `.options(...)` returns a
shallow clone with overridden TaskOptions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

from .object_ref import ObjectRef
from .task_spec import TaskOptions

_VALID_OPTION_KEYS = {f.name for f in dataclasses.fields(TaskOptions)}


def options_from_kwargs(base: TaskOptions, **kwargs) -> TaskOptions:
    opts = dataclasses.replace(base)
    for k, v in kwargs.items():
        if k not in _VALID_OPTION_KEYS:
            raise ValueError(f"Unknown option {k!r}; valid: {sorted(_VALID_OPTION_KEYS)}")
        setattr(opts, k, v)
    opts.__post_init__()  # re-normalize (e.g. num_returns="streaming" → -1)
    return opts


class RemoteFunction:
    def __init__(self, func: Callable, options: TaskOptions):
        self._function = func
        self._default_options = options
        self.__name__ = getattr(func, "__name__", "remote_function")
        self.__doc__ = getattr(func, "__doc__", None)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote()."
        )

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def _submit_func(self):
        """The function as a pre-pickled blob, computed once per wrapper
        (runtime.CachedFuncBlob — executors cache the unpickle by hash)."""
        cached = self.__dict__.get("_cached_blob")
        if cached is None:
            import hashlib

            import cloudpickle

            from .runtime import CachedFuncBlob

            blob = cloudpickle.dumps(self._function)
            cached = CachedFuncBlob(
                blob, hashlib.sha1(blob).hexdigest(), self.__name__
            )
            self.__dict__["_cached_blob"] = cached
        return cached

    def options(self, **option_kwargs) -> "RemoteFunction":
        new_opts = options_from_kwargs(self._default_options, **option_kwargs)
        return RemoteFunction(self._function, new_opts)

    def _remote(self, args, kwargs, opts: TaskOptions):
        from . import api

        runtime = api._global_runtime()
        refs = runtime.submit_task(self._submit_func(), args, kwargs, opts)
        if opts.num_returns == -1:  # streaming/dynamic (canonical sentinel)
            return refs  # an ObjectRefGenerator
        if opts.num_returns == 1:
            return refs[0]
        if opts.num_returns == 0:
            return None
        return refs

    def bind(self, *args, **kwargs):
        """Build a DAG node (reference: `python/ray/dag`)."""
        from ..dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    @property
    def func(self) -> Callable:
        return self._function
