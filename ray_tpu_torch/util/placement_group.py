"""Placement groups — gang scheduling of resource bundles.

Reference: `python/ray/util/placement_group.py` (`placement_group()` `:146`)
with strategies PACK / SPREAD / STRICT_PACK / STRICT_SPREAD. On TPU, a
STRICT_PACK group over `TPU` bundles is how a slice gang is reserved
(reference precedent: `_private/accelerators/tpu.py:199-313` pod resources).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    def ready(self):
        """Returns an ObjectRef resolving when the group is placed."""
        from ..core import api

        pg = self

        @api.remote
        def _pg_ready():
            return True

        backend = api._global_runtime().backend
        backend.placement_group_ready(pg.id, None)
        return _pg_ready.options(
            scheduling_strategy=_pg_strategy(pg, 0)
        ).remote()

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        from ..core import api

        return api._global_runtime().backend.placement_group_ready(
            self.id, timeout_seconds
        )

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy))


def _pg_strategy(pg: PlacementGroup, bundle_index: int):
    from ..core.task_spec import PlacementGroupSchedulingStrategy

    return PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=bundle_index
    )


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy}; valid: {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement_group requires at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"Invalid bundle {b}")
    from ..core import api

    pg_id = PlacementGroupID.from_random()
    api._global_runtime().backend.create_placement_group(pg_id, bundles, strategy, name)
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup):
    from ..core import api

    api._global_runtime().backend.remove_placement_group(pg.id)


def get_current_placement_group() -> Optional[PlacementGroup]:
    return None
