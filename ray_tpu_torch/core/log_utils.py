"""Log-file tailing shared by the controller and node agents
(reference analog: `python/ray/_private/log_monitor.py` file cursors)."""

from __future__ import annotations

from typing import Optional, Tuple


def read_log_chunk(path: str, offset: int, cap: Optional[int] = None) -> Optional[Tuple[bytes, int]]:
    """Read a log increment, holding back a trailing partial line so the
    consumer never prints fragments or splits multi-byte characters (unless
    a single line exceeds the cap). Returns (data, new_offset) or None."""
    if cap is None:
        from . import config as rt_config

        cap = rt_config.get("log_chunk_bytes")
    try:
        import os

        # One stat instead of open+seek+read for the (overwhelmingly
        # common) unchanged file — thousands of idle workers are polled
        # every second.
        if os.path.getsize(path) <= offset:
            return None
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(cap)
    except OSError:
        return None
    if not data:
        return None
    if not data.endswith(b"\n"):
        cut = data.rfind(b"\n")
        if cut >= 0:
            data = data[: cut + 1]
        elif len(data) < cap:
            return None  # mid-line write in progress; wait for the newline
    return data, offset + len(data)
