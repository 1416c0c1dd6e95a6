"""Bin-packing of unmet resource demand onto node types.

Reference analog: `python/ray/autoscaler/_private/resource_demand_scheduler.py`
— first-fit-decreasing over existing capacity, then over planned new nodes,
choosing node types that fit; bounded by per-type and global max_workers.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

EPS = 1e-9


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + EPS >= v for k, v in demand.items())


def _take(avail: Dict[str, float], demand: Dict[str, float]):
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


def _size(demand: Dict[str, float]) -> float:
    # GPU demand dominates the ordering so accelerator bundles pack first
    # (and accelerator node types sort last).
    # reference: return demand.get("TPU", 0.0) * 1e6 + ..., ray_tpu/autoscaler/resource_demand_scheduler.py:26
    return demand.get("GPU", 0.0) * 1e6 + sum(demand.values())


def pack_feasible(
    capacities: List[Dict[str, float]], demands: List[Dict[str, float]]
) -> bool:
    """First-fit-decreasing check: do all demand bundles pack into the given
    capacities? Used for idle-termination safety against the explicit floor."""
    scratch = [dict(c) for c in capacities]
    for demand in sorted(demands, key=_size, reverse=True):
        for cap in scratch:
            if _fits(cap, demand):
                _take(cap, demand)
                break
        else:
            return False
    return True


def get_nodes_to_launch(
    node_types: Dict[str, dict],
    counts_by_type: Dict[str, int],
    existing_avail,
    demands: List[Dict[str, float]],
    explicit_demands: List[Dict[str, float]],
    existing_totals=None,
    max_workers: int = 64,
    strict_spread_groups: List[dict] = (),
) -> Dict[str, int]:
    """Decide how many new nodes of each type to launch.

    `node_types`: {type_name: {"resources": {...}, "min_workers": int,
    "max_workers": int}}. `counts_by_type`: live worker-node counts.
    `existing_avail`: available resources of live nodes — a
    {node_id: resources} mapping, or a bare list when node identity does not
    matter (demands consume these first). `explicit_demands` are matched
    against whole-node *totals* (capacity floor semantics of
    `request_resources`). `strict_spread_groups` entries are
    {"bundles": [...], "occupied": [node_id, ...]} — each bundle needs a
    distinct node, and nodes in `occupied` are excluded (they already host
    this PG's surviving bundles).
    """
    if not isinstance(existing_avail, dict):
        existing_avail = {f"#{i}": a for i, a in enumerate(existing_avail)}
    if existing_totals is not None and not isinstance(existing_totals, dict):
        existing_totals = {f"#{i}": t for i, t in enumerate(existing_totals)}
    to_launch: Dict[str, int] = {}
    planned: List[Tuple[str, Dict[str, float]]] = []  # (type, remaining avail)
    total_workers = sum(counts_by_type.values())

    def type_count(t: str) -> int:
        return counts_by_type.get(t, 0) + to_launch.get(t, 0)

    def can_add(t: str) -> bool:
        spec = node_types[t]
        return (
            type_count(t) < spec.get("max_workers", max_workers)
            and total_workers + sum(to_launch.values()) < max_workers
        )

    def add_node(t: str) -> Dict[str, float]:
        to_launch[t] = to_launch.get(t, 0) + 1
        avail = dict(node_types[t]["resources"])
        planned.append((t, avail))
        return avail

    # 1. min_workers floors.
    for t, spec in node_types.items():
        while type_count(t) < spec.get("min_workers", 0) and can_add(t):
            add_node(t)

    # 2. Queued-task / PG-bundle demand: first-fit-decreasing against live
    # availability, then planned nodes, then new nodes.
    by_node = {nid: dict(a) for nid, a in existing_avail.items()}
    scratch = list(by_node.values())

    # 2a. STRICT_SPREAD placement groups: every bundle in a group must land
    # on a DISTINCT capacity unit (existing node or planned node) — plain
    # packing would co-pack them and permanently under-launch. Nodes already
    # hosting the group's surviving bundles are excluded up front.
    for group in strict_spread_groups:
        if isinstance(group, dict):
            bundles = group.get("bundles", [])
            occupied = group.get("occupied", [])
        else:  # bare bundle list (tests/back-compat)
            bundles, occupied = group, []
        used_ids = {id(by_node[nid]) for nid in occupied if nid in by_node}
        for demand in sorted(bundles, key=_size, reverse=True):
            placed = False
            for avail in scratch:
                if id(avail) not in used_ids and _fits(avail, demand):
                    _take(avail, demand)
                    used_ids.add(id(avail))
                    placed = True
                    break
            if placed:
                continue
            for _, avail in planned:
                if id(avail) not in used_ids and _fits(avail, demand):
                    _take(avail, demand)
                    used_ids.add(id(avail))
                    placed = True
                    break
            if placed:
                continue
            for t in sorted(
                node_types, key=lambda t: _size(node_types[t]["resources"])
            ):
                if _fits(node_types[t]["resources"], demand) and can_add(t):
                    avail = add_node(t)
                    _take(avail, demand)
                    used_ids.add(id(avail))
                    break
    for demand in sorted(demands, key=_size, reverse=True):
        placed = False
        for avail in scratch:
            if _fits(avail, demand):
                _take(avail, demand)
                placed = True
                break
        if placed:
            continue
        for _, avail in planned:
            if _fits(avail, demand):
                _take(avail, demand)
                placed = True
                break
        if placed:
            continue
        for t in sorted(node_types, key=lambda t: _size(node_types[t]["resources"])):
            if _fits(node_types[t]["resources"], demand) and can_add(t):
                _take(add_node(t), demand)
                break

    # 3. Explicit requests are a capacity floor: pack them against node
    # *totals* (live + planned), ignoring current usage.
    source = existing_totals if existing_totals is not None else existing_avail
    totals = [dict(t) for t in source.values()]
    totals += [dict(node_types[t]["resources"]) for t, _ in planned]
    for demand in sorted(explicit_demands, key=_size, reverse=True):
        placed = False
        for cap in totals:
            if _fits(cap, demand):
                _take(cap, demand)
                placed = True
                break
        if placed:
            continue
        for t in sorted(node_types, key=lambda t: _size(node_types[t]["resources"])):
            if _fits(node_types[t]["resources"], demand) and can_add(t):
                cap = add_node(t)
                _take(cap, demand)
                totals.append(cap)
                break

    return to_launch
