"""Node memory-pressure monitoring (reference analog:
`src/ray/common/memory_monitor.h:52` — periodic usage sampling against a
threshold — plus the raylet worker-killing policies,
`worker_killing_policy_group_by_owner.cc`).

Redesign: agents (and the controller, for head-node workers) sample
`/proc/meminfo` + per-worker RSS on an interval. Over-threshold nodes
report their candidate workers to the CONTROLLER, which picks the victim
with global knowledge (task workers before actor hosts, largest RSS first
— the allocator is almost always the largest) and kills it; the normal
worker-death path then retries the killed task with an OOM-labelled error
when retries run out. A runaway allocation costs one worker, not the node.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

_PAGE = os.sysconf("SC_PAGE_SIZE")


def node_memory() -> Tuple[int, int]:
    """(total_bytes, available_bytes) from /proc/meminfo."""
    total = avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
            if total and avail:
                break
    return total, avail


def process_rss(pid: int) -> int:
    """Resident set size of one process in bytes (0 if gone)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


class MemoryPressureSampler:
    """Threshold check + candidate collection for one node's worker set."""

    def __init__(self, limit_bytes: int = 0, threshold: float = 0.95):
        self.limit_bytes = limit_bytes
        self.threshold = threshold

    def over_threshold(self) -> Optional[dict]:
        """Usage snapshot when over the limit, else None."""
        total, avail = node_memory()
        if total <= 0:
            return None
        limit = self.limit_bytes or int(total * self.threshold)
        used = total - avail
        if used <= limit:
            return None
        return {"used": used, "limit": limit, "total": total}

    @staticmethod
    def candidates(pids: Dict[str, int]) -> List[Tuple[str, int]]:
        """[(worker_id, rss_bytes)] sorted largest-first."""
        out = [(wid, process_rss(pid)) for wid, pid in pids.items()]
        out.sort(key=lambda t: -t[1])
        return out
