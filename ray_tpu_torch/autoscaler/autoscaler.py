"""StandardAutoscaler — the update loop.

Reference analog: `python/ray/autoscaler/_private/autoscaler.py`
`StandardAutoscaler.update` (:171,373) run periodically by `Monitor`
(`monitor.py:126,231`): read load metrics, terminate idle nodes, bin-pack
unmet demand into node launches.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from .load_metrics import LoadMetrics
from .node_provider import (
    NODE_KIND_WORKER,
    TAG_NODE_KIND,
    TAG_NODE_TYPE,
    NodeProvider,
)
from .resource_demand_scheduler import get_nodes_to_launch, pack_feasible as _packs

logger = logging.getLogger(__name__)

DEFAULT_CONFIG = {
    "max_workers": 8,
    "idle_timeout_s": 60.0,
    "available_node_types": {},
}


class StandardAutoscaler:
    """One `update()` = one reconcile pass. The caller owns the cadence
    (`Monitor` below, or tests calling update() directly)."""

    def __init__(self, config: dict, provider: NodeProvider, backend):
        self.config = {**DEFAULT_CONFIG, **config}
        self.provider = provider
        self.backend = backend  # ClusterBackend-compatible (._request)
        self.load_metrics = LoadMetrics()

    # ---------------------------------------------------------------- state
    def _worker_nodes_by_type(self) -> Dict[str, list]:
        by_type: Dict[str, list] = {}
        for nid in self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: NODE_KIND_WORKER}
        ):
            t = self.provider.node_tags(nid).get(TAG_NODE_TYPE, "")
            by_type.setdefault(t, []).append(nid)
        return by_type

    # --------------------------------------------------------------- update
    def update(self) -> Dict[str, int]:
        """Returns {node_type: launched_count} for observability/tests."""
        raw = self.backend._request({"type": "load_metrics"})
        self.load_metrics.update(raw)

        self._terminate_idle_nodes()

        node_types: Dict[str, dict] = self.config["available_node_types"]
        by_type = self._worker_nodes_by_type()
        counts = {t: len(v) for t, v in by_type.items()}
        # Launched-but-unregistered nodes count as full pending capacity so a
        # fast second update() doesn't double-launch (reference: pending-launch
        # accounting in `resource_demand_scheduler` via `pending_launches`).
        registered = set(self.load_metrics.alive_node_avail())
        pending_caps = {
            nid: dict(node_types[t]["resources"])
            for t, nids in by_type.items()
            if t in node_types
            for nid in nids
            if nid not in registered
        }
        to_launch = get_nodes_to_launch(
            node_types=node_types,
            counts_by_type=counts,
            existing_avail={
                **self.load_metrics.alive_node_avail(),
                **{k: dict(v) for k, v in pending_caps.items()},
            },
            demands=self.load_metrics.unmet_demands(),
            explicit_demands=self.load_metrics.explicit_demands,
            existing_totals={
                **self.load_metrics.alive_node_total(),
                **{k: dict(v) for k, v in pending_caps.items()},
            },
            max_workers=self.config["max_workers"],
            strict_spread_groups=self.load_metrics.strict_spread_groups,
        )
        for t, count in to_launch.items():
            logger.info("autoscaler: launching %d x %s", count, t)
            self.provider.create_node(
                node_types[t],
                {TAG_NODE_KIND: NODE_KIND_WORKER, TAG_NODE_TYPE: t},
                count,
            )
        return to_launch

    def _terminate_idle_nodes(self):
        idle = set(self.load_metrics.idle_nodes(self.config["idle_timeout_s"]))
        if not idle:
            return
        node_types = self.config["available_node_types"]
        by_type = self._worker_nodes_by_type()
        # Capacity the explicit request_resources floor still needs: a node
        # is only removable if the floor still packs into what remains
        # (otherwise terminate/relaunch would churn forever).
        remaining_totals = dict(self.load_metrics.alive_node_total())
        for t, nids in by_type.items():
            floor = node_types.get(t, {}).get("min_workers", 0)
            removable = [n for n in nids if n in idle]
            # Keep at least min_workers of this type alive.
            excess = len(nids) - floor
            for nid in removable[: max(0, excess)]:
                after = {k: v for k, v in remaining_totals.items() if k != nid}
                if not _packs(
                    list(after.values()), self.load_metrics.explicit_demands
                ):
                    continue
                logger.info("autoscaler: terminating idle node %s", nid)
                self.provider.terminate_node(nid)
                remaining_totals = after


class Monitor:
    """Background thread running `autoscaler.update()` on a fixed cadence
    (reference: `monitor.py` process on the head node)."""

    def __init__(self, autoscaler: StandardAutoscaler, update_interval_s: float = 5.0):
        self.autoscaler = autoscaler
        self.update_interval_s = update_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception:  # noqa: BLE001 — keep the loop alive
                logger.exception("autoscaler update failed")
            self._stop.wait(self.update_interval_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
