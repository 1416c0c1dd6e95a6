"""Lazy task DAGs (reference: `python/ray/dag`).

`fn.bind(...)` builds a graph; `.execute()` submits it. The compiled path
(static DAG onto long-lived actors — reference `compiled_dag_node.py`) is the
substrate for pipeline parallelism and is implemented in
`ray_tpu_torch.parallel.pipeline` on top of these nodes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DAGNode:
    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def _resolve(self, node_results: dict, input_value):
        def sub(x):
            if isinstance(x, DAGNode):
                return x.execute_with_cache(node_results, input_value)
            if isinstance(x, InputNode):
                return input_value
            return x

        args = tuple(sub(a) for a in self._bound_args)
        kwargs = {k: sub(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def execute_with_cache(self, node_results: dict, input_value):
        if id(self) not in node_results:
            node_results[id(self)] = self._execute_impl(node_results, input_value)
        return node_results[id(self)]

    def execute(self, input_value=None):
        """Submit the whole DAG; returns the ObjectRef of this node's result."""
        return self.execute_with_cache({}, input_value)

    def experimental_compile(self, _buffer_size_bytes: int = 1 << 20):
        """Compile onto long-lived actors + reusable shm channels
        (reference: `compiled_dag_node.py`); see `ray_tpu_torch.dag.compiled`."""
        from .compiled import CompiledDAG

        return CompiledDAG(self, _buffer_size_bytes)

    def _execute_impl(self, node_results, input_value):
        raise NotImplementedError


class InputNode(DAGNode):
    """Placeholder for the DAG's runtime input."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def _execute_impl(self, node_results, input_value):
        return input_value


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, node_results, input_value):
        args, kwargs = self._resolve(node_results, input_value)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._handle = None

    def handle(self):
        if self._handle is None:
            args, kwargs = self._resolve({}, None)
            self._handle = self._actor_cls.remote(*args, **kwargs)
        return self._handle

    def _execute_impl(self, node_results, input_value):
        return self.handle()

    def __getattr__(self, method_name):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        node = self

        class _MethodBinder:
            def bind(self, *args, **kwargs):
                return ActorMethodNode(node, method_name, args, kwargs)

        return _MethodBinder()


class ActorMethodNode(DAGNode):
    def __init__(self, target, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._target = target  # ClassNode or ActorHandle
        self._method_name = method_name

    def _execute_impl(self, node_results, input_value):
        args, kwargs = self._resolve(node_results, input_value)
        target = self._target
        if isinstance(target, ClassNode):
            target = target.handle()
        return getattr(target, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Groups several leaf nodes into one executable (reference: OutputNode)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_impl(self, node_results, input_value):
        return [
            o.execute_with_cache(node_results, input_value) for o in self._bound_args
        ]


__all__ = [
    "DAGNode",
    "InputNode",
    "FunctionNode",
    "ClassNode",
    "ActorMethodNode",
    "MultiOutputNode",
    "CompiledDAG",
    "CompiledDAGRef",
]


def __getattr__(name):
    if name in ("CompiledDAG", "CompiledDAGRef"):
        from . import compiled

        return getattr(compiled, name)
    raise AttributeError(name)
