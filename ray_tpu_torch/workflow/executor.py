"""Workflow executor — checkpointed DAG walking with retries/continuations.

Reference analog: `python/ray/workflow/workflow_executor.py` +
`workflow_state_from_dag.py`: each step runs as a task, its result is durably
checkpointed, and resume replays only the steps without checkpoints.

Step identity: nodes get deterministic keys from a structural DFS of the
bound DAG (same DAG → same keys across processes/pickling), so resume after
a crash matches checkpoints to steps without a registry.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..dag import DAGNode, FunctionNode, InputNode, MultiOutputNode
from .storage import WorkflowStorage

# Workflow statuses (reference: `python/ray/workflow/common.py` WorkflowStatus).
RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"
CANCELED = "CANCELED"
RESUMABLE = "RESUMABLE"


class WorkflowCancellationError(Exception):
    pass


def _step_name(node: DAGNode) -> str:
    fn = getattr(node, "_remote_fn", None)
    return getattr(fn, "__name__", None) or type(node).__name__.lower()


def assign_step_keys(root: DAGNode, prefix: str = "") -> Dict[int, str]:
    """Deterministic structural DFS over bound args — stable across pickle
    round-trips, which is what makes crash-resume line up with checkpoints."""
    keys: Dict[int, str] = {}
    counter = [0]

    def visit(node):
        if not isinstance(node, DAGNode) or id(node) in keys:
            return
        for a in node._bound_args:
            visit(a)
        for v in node._bound_kwargs.values():
            visit(v)
        if isinstance(node, MultiOutputNode):
            for o in node._outputs:
                visit(o)
        idx = counter[0]
        counter[0] += 1
        keys[id(node)] = f"{prefix}{idx}_{_step_name(node)}"

    visit(root)
    return keys


class WorkflowExecutor:
    def __init__(self, storage: WorkflowStorage, workflow_id: str):
        self.storage = storage
        self.workflow_id = workflow_id
        self._cache_lock = threading.Lock()

    # ------------------------------------------------------------ execution
    def run(self, dag: DAGNode, input_value=None) -> Any:
        """Execute to completion (or raise); returns the final output.
        The caller (run_async) has already marked the workflow RUNNING."""
        try:
            out = self._exec_subdag(dag, input_value, prefix="")
            self.storage.save_output(self.workflow_id, out)
            self.storage.set_status(self.workflow_id, SUCCESSFUL)
            return out
        except WorkflowCancellationError:
            self.storage.set_status(self.workflow_id, CANCELED)
            raise
        except BaseException:
            self.storage.set_status(self.workflow_id, FAILED)
            raise

    def _exec_subdag(self, root: DAGNode, input_value, prefix: str) -> Any:
        keys = assign_step_keys(root, prefix)
        cache: Dict[int, Any] = {}
        return self._exec_node(root, keys, cache, input_value)

    def _exec_many(self, nodes, keys, cache, input_value) -> List[Any]:
        """Evaluate sibling subtrees concurrently — independent DAG branches
        run in parallel on the cluster instead of serializing on the
        driver's blocking get (one thread per extra branch; DAG widths are
        small)."""
        dag_children = [n for n in nodes if isinstance(n, DAGNode)]
        if len(dag_children) > 1:
            results: Dict[int, Any] = {}
            errors: List[BaseException] = []

            def work(i, n):
                try:
                    results[i] = self._exec_node(n, keys, cache, input_value)
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

            threads = [
                threading.Thread(target=work, args=(i, n), daemon=True)
                for i, n in enumerate(nodes)
                if isinstance(n, DAGNode)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            return [
                results[i] if isinstance(n, DAGNode) else n
                for i, n in enumerate(nodes)
            ]
        return [self._exec_node(n, keys, cache, input_value) for n in nodes]

    def _exec_node(self, node, keys, cache, input_value) -> Any:
        if not isinstance(node, DAGNode):
            return node
        # Memoized single execution per node, safe under branch threads:
        # the first visitor claims the slot; later visitors wait on its event.
        with self._cache_lock:
            slot = cache.get(id(node))
            owner = slot is None
            if owner:
                slot = cache[id(node)] = {"event": threading.Event()}
        if not owner:
            slot["event"].wait()
            if "error" in slot:
                raise slot["error"]
            return slot["value"]
        try:
            val = self._compute_node(node, keys, cache, input_value)
            slot["value"] = val
            return val
        except BaseException as e:  # noqa: BLE001
            slot["error"] = e
            raise
        finally:
            slot["event"].set()

    def _compute_node(self, node, keys, cache, input_value) -> Any:
        if isinstance(node, InputNode):
            return input_value
        if isinstance(node, MultiOutputNode):
            return self._exec_many(node._outputs, keys, cache, input_value)

        key = keys[id(node)]
        if self.storage.has_step(self.workflow_id, key):
            return self._resolve_continuations(
                self.storage.load_step(self.workflow_id, key), key, input_value
            )

        if self.storage.cancel_requested(self.workflow_id):
            raise WorkflowCancellationError(self.workflow_id)

        bound = list(node._bound_args) + list(node._bound_kwargs.values())
        vals = self._exec_many(bound, keys, cache, input_value)
        args = vals[: len(node._bound_args)]
        kwargs = dict(zip(node._bound_kwargs.keys(), vals[len(node._bound_args):]))
        val = self._run_step(node, key, args, kwargs)
        opts = getattr(node, "_workflow_options", None) or {}
        if opts.get("checkpoint", True):
            self.storage.save_step(self.workflow_id, key, val)
        return self._resolve_continuations(val, key, input_value)

    def _resolve_continuations(self, val, key: str, input_value) -> Any:
        """A step (root or nested) may return another DAG — keep walking it
        durably under a key-prefixed namespace (reference:
        `workflow.continuation`)."""
        depth = 0
        while isinstance(val, DAGNode):
            depth += 1
            val = self._exec_subdag(val, input_value, prefix=f"{key}.c{depth}.")
        return val

    def _run_step(self, node, key: str, args: List, kwargs: dict) -> Any:
        """One step = one task submission, retried per step options
        (reference: per-step `max_retries` in `workflow/common.py`)."""
        from ..core import api

        opts = getattr(node, "_workflow_options", None) or {}
        max_retries = int(opts.get("max_retries", 0))
        catch = bool(opts.get("catch_exceptions", False))
        if not isinstance(node, FunctionNode):
            raise TypeError(
                f"workflow steps must be function nodes, got {type(node).__name__} "
                "(actor nodes are not durable — reference workflow has the "
                "same task-only restriction for checkpointed steps)"
            )
        attempt = 0
        while True:
            if self.storage.cancel_requested(self.workflow_id):
                raise WorkflowCancellationError(self.workflow_id)
            try:
                val = api.get(node._remote_fn.remote(*args, **kwargs))
                return (val, None) if catch else val
            except WorkflowCancellationError:
                raise
            except Exception as e:  # noqa: BLE001
                if attempt < max_retries:
                    attempt += 1
                    time.sleep(min(0.2 * attempt, 2.0))
                    continue
                if catch:
                    return (None, e)
                raise
