"""LoadMetrics — the autoscaler's view of demand and utilization.

Reference analog: `python/ray/autoscaler/_private/load_metrics.py:63` —
aggregated from GCS resource batches there; here one `load_metrics` RPC to
the controller returns the whole picture (single control process).
"""

from __future__ import annotations

from typing import Dict, List


class LoadMetrics:
    def __init__(self):
        self.pending_demands: List[Dict[str, float]] = []
        self.pending_pg_bundles: List[Dict[str, float]] = []
        self.strict_spread_groups: List[dict] = []  # {"bundles": [...], "occupied": [...]}
        self.explicit_demands: List[Dict[str, float]] = []
        self.nodes: List[dict] = []  # controller node reports

    def update(self, raw: dict):
        self.pending_demands = raw.get("pending_demands", [])
        self.explicit_demands = raw.get("explicit_demands", [])
        # STRICT_SPREAD groups keep their identity — each bundle needs a
        # DISTINCT node, which plain bin-packing would violate (co-packing
        # two bundles onto one planned node would under-launch and deadlock
        # the PG). Other strategies flatten into ordinary demands.
        self.pending_pg_bundles = [
            dict(b)
            for pg in raw.get("pending_pgs", [])
            if pg.get("strategy") != "STRICT_SPREAD"
            for b in pg.get("bundles", [])
        ]
        self.strict_spread_groups = [
            {
                "bundles": [dict(b) for b in pg.get("bundles", [])],
                "occupied": list(pg.get("occupied", [])),
            }
            for pg in raw.get("pending_pgs", [])
            if pg.get("strategy") == "STRICT_SPREAD"
        ]
        self.nodes = raw.get("nodes", [])

    # ------------------------------------------------------------- derived
    def unmet_demands(self) -> List[Dict[str, float]]:
        """Every bundle the cluster has queued but cannot run right now,
        plus pending PG bundles and the explicit `request_resources` floor
        (the latter is a floor on *capacity*, so it is matched against node
        totals by the demand scheduler, not queued tasks)."""
        return [d for d in self.pending_demands if d] + self.pending_pg_bundles

    def idle_nodes(self, idle_timeout_s: float) -> List[str]:
        return [
            n["node_id"]
            for n in self.nodes
            if n["alive"] and not n["is_head"] and n["idle_s"] >= idle_timeout_s
        ]

    def alive_node_avail(self) -> Dict[str, Dict[str, float]]:
        return {
            n["node_id"]: dict(n["available"]) for n in self.nodes if n["alive"]
        }

    def alive_node_total(self) -> Dict[str, Dict[str, float]]:
        return {n["node_id"]: dict(n["total"]) for n in self.nodes if n["alive"]}
