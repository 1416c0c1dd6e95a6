"""ray_tpu_torch.train.mpmd — MPMD pipeline parallelism + ZeRO sharded
updates (port of `ray_tpu/train/mpmd/`).

The training-at-scale composition (arXiv 2412.14374 + 2004.13336): the
model splits into S stages, each stage a SEPARATE program on its own gang
actor (not one SPMD program over a pp axis — that in-mesh path stays in
`ray_tpu_torch.parallel.pipeline`), a host-side 1F1B schedule drives
microbatch activations/grads stage-to-stage over compiled-DAG channels with
large tensors riding arena segments + bulk span pulls, and each stage's
data-parallel replicas run the ZeRO-sharded weight update (reduce-scatter
grads, 1/dp optimizer-state shards, all-gather params). Composed with
`train.elastic`: a member death aborts the mesh via the gang supervisor, dp
is re-picked from feasible capacity, and stage-local checkpoint shards
restore across the reshape.

The port's stage programs are eager torch on the card (the model's flash
and RMSNorm kernels forward and backward); its stage actors are GPU
workers; tensors cross the planes as numpy arrays (bf16 as tagged uint16
bits).

Entry points:
  * `MPMDTrainer` (trainer.py) — the cluster trainer (gang actors).
  * `run_local_pipeline` (local.py) — same runners on threads; parity
    harness and schedule gate.
  * `StageRunner`, `build_1f1b`/`build_interleaved_1f1b`, `ShardedAdamW`,
    `WireCodec` — the composable pieces (interleaved virtual stages cut
    the bubble toward (S-1)/(v*M+S-1); the bf16 wire halves hop bytes).
"""

from .schedule import (
    build_1f1b,
    build_interleaved_1f1b,
    max_in_flight,
    theoretical_bubble_fraction,
)
from .stage import StageRunner
from .transport import ActTransport, ChannelEdge, LocalEdge, WireCodec
from .zero import (
    LocalDpComm,
    ReplicatedAdamW,
    ShardedAdamW,
    SoloComm,
    StoreDpComm,
    make_local_comms,
)
from .local import run_local_pipeline
from .trainer import MPMDOptions, MPMDTrainer

__all__ = [
    "build_1f1b",
    "build_interleaved_1f1b",
    "WireCodec",
    "max_in_flight",
    "theoretical_bubble_fraction",
    "StageRunner",
    "ActTransport",
    "ChannelEdge",
    "LocalEdge",
    "ShardedAdamW",
    "ReplicatedAdamW",
    "SoloComm",
    "StoreDpComm",
    "LocalDpComm",
    "make_local_comms",
    "run_local_pipeline",
    "MPMDOptions",
    "MPMDTrainer",
]
