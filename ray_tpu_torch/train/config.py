"""Run/scaling/checkpoint/failure configs (reference: `python/ray/air/config.py`)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..core.devices import ACCELERATOR  # the GPU resource key (the reference's "TPU")


@dataclass
class ScalingConfig:
    """How many workers and what each needs.

    Reference analog: `air/config.py ScalingConfig` (num_workers,
    use_gpu, resources_per_worker). TPU addition: `topology` — a mesh axis
    dict (e.g. {"dp": 4, "tp": 4}) describing the global device mesh the
    worker gang should assemble.
    """

    num_workers: int = 1
    # Ray's name; the reference's `use_tpu` (`ray_tpu/train/config.py:21`).
    use_gpu: bool = False
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"
    topology: Optional[Dict[str, int]] = None
    # Elasticity band (train/elastic): on a gang restart the supervisor may
    # re-form the gang with any world size in [min_workers, max_workers]
    # when the full `num_workers` gang is infeasible (capacity lost with a
    # node, say). None/None disables shrinking — restarts always demand the
    # original world size.
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None

    def elastic_band(self) -> "tuple[int, int]":
        """(lo, hi) world-size band, clamped to sane values. `is None`
        checks, not truthiness: min_workers=0 means "shrink to any size",
        not "band unset"."""
        hi = self.num_workers if self.max_workers is None else self.max_workers
        lo = hi if self.min_workers is None else self.min_workers
        lo = max(1, min(lo, hi))
        return lo, hi

    def pick_world_size(
        self,
        feasible: Optional[int],
        band: "Optional[tuple[int, int]]" = None,
    ) -> int:
        """World size for a (re)start given `feasible` workers' worth of
        capacity (None = unknown → demand the full band top). `band`
        overrides elastic_band(): pass a snapshot taken from the ORIGINAL
        config when (like BackendExecutor.run) the caller mutates
        num_workers on a shrink — deriving the ceiling from the mutated
        value would ratchet the gang down permanently."""
        lo, hi = band if band is not None else self.elastic_band()
        if feasible is None:
            return hi
        return max(lo, min(hi, feasible))

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        # The GPU worker kind, where the reference asks for "TPU"
        # (`ray_tpu/train/config.py:60`).
        if self.use_gpu and ACCELERATOR not in res:
            res[ACCELERATOR] = 1.0
        if "CPU" not in res:
            res["CPU"] = 1.0
        return res


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class FailureConfig:
    """Gang failure policy (consumed by train/elastic's GangSupervisor).

    max_failures: restart budget — how many gang restarts before the run
        surfaces the error (-1 = unbounded). 0 keeps the legacy behavior:
        first failure is final.
    abort_deadline_s: after a member death the whole mesh must be aborted
        (collectives interrupted, surviving members torn down) within this
        many seconds — a wedged barrier past the deadline is a bug.
    backoff_base_s / backoff_max_s: exponential backoff between gang
        restarts: min(backoff_base_s * 2**attempt, backoff_max_s).
    """

    max_failures: int = 0
    abort_deadline_s: float = 10.0
    backoff_base_s: float = 0.25
    backoff_max_s: float = 15.0


@dataclass
class DataConfig:
    datasets_to_split: Any = "all"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    stop: Optional[dict] = None
    verbose: int = 1

    def resolve_storage(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results"
        )
        name = self.name or "run"
        return os.path.join(base, name)
