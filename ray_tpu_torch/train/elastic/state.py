"""Deterministic-resume state that travels with every elastic checkpoint.

The contract (ISSUE 4 tentpole, plane 3): a run killed at step k and resumed
from the last committed checkpoint must produce the SAME loss trajectory as
an unkilled run. That holds iff everything the loop consumes besides the
model shard is restored too — the step counter and the data-iterator
offsets. Offsets are stored GLOBALLY (total samples consumed across the
gang), not per-rank, so a resume with a different world size (elasticity
band shrink) can re-derive each rank's local position: rank r of W workers
continues at global_offset + r, striding W.

Reference analog: TorchTitan (arXiv 2410.06511) checkpoints
(step, dataloader state) next to the DCP shards for exactly this reason.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class ElasticState:
    """Loop progress snapshot. `step` is the NEXT step to run (a checkpoint
    written after finishing step s carries step=s+1)."""

    step: int = 0
    # dataset name -> global sample offset (sum over ranks). World-size
    # independent by construction — see module docstring.
    data_offsets: Dict[str, int] = field(default_factory=dict)
    # Free-form user extras (rng seeds, schedule phase, ...). Must be
    # JSON-serializable.
    extra: Dict[str, Any] = field(default_factory=dict)

    # -------------------------------------------------------------- codec
    def to_payload(self) -> Dict[str, Any]:
        return {
            "step": int(self.step),
            "data_offsets": {str(k): int(v) for k, v in self.data_offsets.items()},
            "extra": dict(self.extra),
        }

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "ElasticState":
        return cls(
            step=int(payload.get("step", 0)),
            data_offsets={
                str(k): int(v)
                for k, v in (payload.get("data_offsets") or {}).items()
            },
            extra=dict(payload.get("extra") or {}),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_payload())

    @classmethod
    def loads(cls, raw: str) -> "ElasticState":
        return cls.from_payload(json.loads(raw))

    # ------------------------------------------------------------ helpers
    def local_offset(self, name: str, rank: int, world_size: int) -> int:
        """Rank r's first sample index for dataset `name` under a
        rank-strided (round-robin) sharding: global samples are dealt
        rank, rank+W, rank+2W, ... — world-size changes just change the
        stride, never skip or replay a sample."""
        base = int(self.data_offsets.get(name, 0))
        # First global index not yet consumed is `base`; rank r's next
        # sample is the smallest i >= base with i % world_size == rank.
        rem = (rank - base) % world_size
        return base + rem

    def advance(self, name: str, consumed_global: int) -> None:
        self.data_offsets[name] = (
            int(self.data_offsets.get(name, 0)) + int(consumed_global)
        )

    # ------------------------------------------------------- MPMD pipeline
    def record_pipeline(
        self, stage: int, num_stages: int, num_chunks: int = 1
    ) -> None:
        """Stamp the pipeline position this shard belongs to. dp width is
        deliberately NOT recorded as a constraint — reshapes change it and
        the axis-0 reshard absorbs that — but the STAGE SPLIT (stages AND
        interleaved chunks: both change the flat-space layout) must match
        on restore: a stage-1-of-2 optimizer shard loaded into stage 1 of
        3 would silently install the wrong slice of the model."""
        self.extra["pipeline"] = {
            "stage": int(stage),
            "num_stages": int(num_stages),
            "num_chunks": int(num_chunks),
        }

    def check_pipeline(
        self, stage: int, num_stages: int, num_chunks: int = 1
    ) -> None:
        got = self.extra.get("pipeline")
        if got is None:
            return  # pre-MPMD checkpoint: nothing to validate against
        want = (int(stage), int(num_stages), int(num_chunks))
        # Checkpoints written before interleaving existed carry no chunk
        # count — they are v=1 by construction.
        have = (
            int(got.get("stage", -1)),
            int(got.get("num_stages", -1)),
            int(got.get("num_chunks", 1)),
        )
        if have != want:
            raise ValueError(
                f"checkpoint belongs to stage {got.get('stage')}/"
                f"{got.get('num_stages')} (x{got.get('num_chunks', 1)} "
                f"chunks) but is being restored into stage "
                f"{stage}/{num_stages} (x{num_chunks} chunks) — stage "
                "splits cannot change across a reshape (only dp width can)"
            )
