"""State observability API — programmatic `list_*` / `summarize_*`.

Reference analog: `python/ray/util/state/api.py` (`list_tasks`,
`list_actors`, `list_objects`, `list_nodes`, `list_workers`, `summary`)
backed by `dashboard/state_aggregator.py`; here the controller's state
handlers serve the same views directly (the CLI `ray_tpu_torch.scripts.cli list`
wraps these).
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _backend():
    from ..core import api

    backend = api._global_runtime().backend
    if not hasattr(backend, "_request"):
        raise RuntimeError(
            "state API needs a cluster backend (init without local_mode)"
        )
    return backend


def _filtered(rows: List[dict], filters) -> List[dict]:
    """filters: [(key, "=", value)] — the reference's predicate tuples."""
    for key, op, value in filters or []:
        if op not in ("=", "!="):
            raise ValueError(f"unsupported filter op {op!r} (use '=' or '!=')")
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        else:
            rows = [r for r in rows if str(r.get(key)) != str(value)]
    return rows


def list_tasks(filters=None, limit: int = 1000) -> List[dict]:
    rows = _backend()._request({"type": "list_tasks"})["tasks"]
    return _filtered(rows, filters)[:limit]


def list_actors(filters=None, limit: int = 1000) -> List[dict]:
    rows = _backend()._request({"type": "list_actors"})["actors"]
    return _filtered(rows, filters)[:limit]


def list_objects(filters=None, limit: int = 1000) -> List[dict]:
    # Filter BEFORE limiting: the server window must not hide matches (ask
    # for a large window when a filter is active).
    server_limit = limit if not filters else max(limit, 100_000)
    rows = _backend()._request({"type": "list_objects", "limit": server_limit})["objects"]
    return _filtered(rows, filters)[:limit]


def list_nodes(filters=None, limit: int = 1000) -> List[dict]:
    rows = _backend()._request({"type": "nodes"})["nodes"]
    return _filtered(rows, filters)[:limit]


def list_workers(filters=None, limit: int = 1000) -> List[dict]:
    rows = _backend()._request({"type": "list_workers"})["workers"]
    return _filtered(rows, filters)[:limit]


def list_placement_groups(filters=None, limit: int = 1000) -> List[dict]:
    rows = _backend()._request({"type": "list_placement_groups"})[
        "placement_groups"
    ]
    return _filtered(rows, filters)[:limit]


def summarize_tasks() -> Dict[str, int]:
    """State counts by task state (reference: `ray summary tasks`)."""
    out: Dict[str, int] = {}
    for row in list_tasks():
        out[row["state"]] = out.get(row["state"], 0) + 1
    return out


def summarize_actors() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for row in list_actors():
        out[row["state"]] = out.get(row["state"], 0) + 1
    return out


def summarize_objects() -> Dict[str, object]:
    rows = list_objects()
    return {
        "total_objects": len(rows),
        "total_size_bytes": sum(r.get("size") or 0 for r in rows),
        "by_status": {
            s: sum(1 for r in rows if r["status"] == s)
            for s in {r["status"] for r in rows}
        },
    }
