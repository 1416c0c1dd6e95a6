"""User-facing exceptions (reference: `python/ray/exceptions.py`)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at `get` with the remote traceback.

    Reference analog: `RayTaskError` — the cause is stored and surfaced at the
    `ray.get` call site.
    """

    def __init__(self, cause: BaseException, traceback_str: str = "", task_name: str = ""):
        self.cause = cause
        self.traceback_str = traceback_str
        self.task_name = task_name
        super().__init__(f"Task {task_name or '<unknown>'} failed: {cause!r}\n{traceback_str}")

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is-a the original type (so `except ValueError`
        works across the process boundary) while keeping the remote traceback."""
        cause = self.cause
        if isinstance(cause, RayTpuError):
            return cause
        try:
            cls = type(
                f"TaskError({type(cause).__name__})",
                (TaskError, type(cause)),
                # Takes the args pickle hands back, so the error survives a second hop
                # (a task whose argument failed). (reference: `lambda self: None`,
                # ray_tpu/core/exceptions.py:33)
                {"__init__": lambda self, *args: None},
            )
            err = cls()
            err.cause = cause
            err.traceback_str = self.traceback_str
            err.task_name = self.task_name
            err.args = (f"{cause}\n\nRemote traceback:\n{self.traceback_str}",)
            return err
        except TypeError:
            return self


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly (reference: WorkerCrashedError)."""


class ActorDiedError(RayTpuError):
    """The actor is dead; pending and future calls fail (reference: RayActorError)."""

    def __init__(self, msg: str = "The actor died unexpectedly before finishing this task."):
        super().__init__(msg)


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unavailable (restarting)."""


class ObjectLostError(RayTpuError):
    """Object can no longer be retrieved and could not be reconstructed."""


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get(..., timeout=)` expired."""


class TaskCancelledError(RayTpuError):
    """Task was cancelled via `cancel()`."""


class PendingCallsLimitExceeded(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    """Raised when the object store or node memory is exhausted."""
