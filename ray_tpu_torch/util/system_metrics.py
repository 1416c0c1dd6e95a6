"""Per-node system metrics (reference analog:
`dashboard/modules/reporter/reporter_agent.py:277` — the psutil-based node
reporter feeding the dashboard and Prometheus).

No psutil dependency: cpu from /proc/stat deltas, memory from
/proc/meminfo, disk from statvfs, the card's memory in use from torch when
the process already drives a card (best-effort — 0.0 when unavailable,
matching nodes without accelerators). (reference: TPU duty cycle from JAX,
ray_tpu/util/system_metrics.py:6-8)"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple


def _cpu_jiffies() -> Tuple[int, int]:
    """(busy, total) jiffies across all cpus."""
    with open("/proc/stat") as f:
        parts = f.readline().split()[1:]
    vals = [int(p) for p in parts]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0)  # idle + iowait
    total = sum(vals)
    return total - idle, total


class SystemMetricsSampler:
    """Stateful sampler: cpu_percent needs a jiffies delta between calls."""

    def __init__(self, disk_path: str = "/"):
        self.disk_path = disk_path
        self._last: Optional[Tuple[int, int]] = None

    def sample(self) -> Dict[str, float]:
        from .memory_monitor import node_memory

        busy, total = _cpu_jiffies()
        cpu_percent = 0.0
        if self._last is not None:
            db = busy - self._last[0]
            dt = total - self._last[1]
            if dt > 0:
                cpu_percent = 100.0 * db / dt
        self._last = (busy, total)
        mem_total, mem_avail = node_memory()
        try:
            st = os.statvfs(self.disk_path)
            disk_total = st.f_frsize * st.f_blocks
            disk_free = st.f_frsize * st.f_bavail
        except OSError:
            disk_total = disk_free = 0
        return {
            "cpu_percent": round(cpu_percent, 1),
            "mem_total_bytes": mem_total,
            "mem_used_bytes": mem_total - mem_avail,
            "disk_total_bytes": disk_total,
            "disk_used_bytes": disk_total - disk_free,
            "gpu_memory_percent": gpu_memory_percent(),  # reference: tpu_duty_cycle, ray_tpu/util/system_metrics.py:58
            "ts": time.time(),
        }


# Slow/failed samples back off with a cooldown instead of a permanent
# latch: one transient hiccup (GC pause, momentary tunnel stall) must not
# kill the metric for the process lifetime. Consecutive bad samples double
# the cooldown up to _TPU_COOLDOWN_MAX_S; one good sample resets it.
_TPU_COOLDOWN_S = 30.0
_TPU_COOLDOWN_MAX_S = 600.0
_tpu_bad_streak = 0
_tpu_retry_at = 0.0


def _tpu_sample_failed():
    global _tpu_bad_streak, _tpu_retry_at
    _tpu_bad_streak += 1
    # Exponent clamped BEFORE pow: an unbounded streak would overflow
    # float pow (~2.0**1024) inside the metrics tick's except handler.
    cooldown = min(
        _TPU_COOLDOWN_S * (2.0 ** min(_tpu_bad_streak - 1, 16)),
        _TPU_COOLDOWN_MAX_S,
    )
    _tpu_retry_at = time.monotonic() + cooldown


def gpu_memory_percent() -> float:
    """Best-effort share of the card's memory in use: reported ONLY from
    processes where torch has ALREADY initialised CUDA (never import torch
    or initialise CUDA here — a metrics sampler that creates a context
    inside a health tick would take seconds and hundreds of MB of the
    card). A slow stats call pauses sampling for a (growing) cooldown, then
    retries. (reference: tpu_duty_cycle over JAX's memory stats,
    ray_tpu/util/system_metrics.py:85-123)"""
    global _tpu_bad_streak
    import sys

    torch = sys.modules.get("torch")
    if time.monotonic() < _tpu_retry_at or torch is None:
        return 0.0
    try:
        if not torch.cuda.is_initialized():
            return 0.0
        t0 = time.monotonic()
        free, total = torch.cuda.mem_get_info()
        if time.monotonic() - t0 > 0.25:
            _tpu_sample_failed()  # too slow to poll
        else:
            _tpu_bad_streak = 0
        return round(100.0 * (total - free) / total, 1) if total else 0.0
    except Exception:  # noqa: BLE001
        _tpu_sample_failed()
        return 0.0
