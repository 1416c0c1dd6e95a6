from . import metrics
from . import state
from .actor_pool import ActorPool
from .queue import Empty, Full, Queue
from .placement_group import (
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    remove_placement_group,
)
from ..core.task_spec import (
    DefaultSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
)

__all__ = [
    "ActorPool",
    "Queue",
    "Empty",
    "state",
    "Full",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "get_current_placement_group",
    "DefaultSchedulingStrategy",
    "SpreadSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
