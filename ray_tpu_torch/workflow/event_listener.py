"""Workflow events (reference: `python/ray/workflow/event_listener.py`).

`wait_for_event(Listener, *args)` produces a DAG node whose step blocks
until the listener observes its event; the observed payload is checkpointed
like any step result, so resumed workflows do not re-wait for events that
already fired.
"""

from __future__ import annotations

import time


class EventListener:
    """Subclass and implement `poll_for_event` (blocking; return the event
    payload). Runs inside a task, so it may poll external systems freely."""

    def poll_for_event(self, *args, **kwargs):
        raise NotImplementedError


class TimerListener(EventListener):
    """Fires after `seconds` (reference: `workflow.sleep`)."""

    def poll_for_event(self, seconds: float):
        time.sleep(float(seconds))
        return time.time()


def wait_for_event(listener_cls, *args, **kwargs):
    """Bind a step that resolves when the listener's event fires."""
    from ..core.api import remote

    if not (isinstance(listener_cls, type) and issubclass(listener_cls, EventListener)):
        raise TypeError("wait_for_event expects an EventListener subclass")

    @remote
    def _wait_for_event(*a, **kw):
        return listener_cls().poll_for_event(*a, **kw)

    _wait_for_event.__name__ = f"wait_{listener_cls.__name__}"
    return _wait_for_event.bind(*args, **kwargs)
