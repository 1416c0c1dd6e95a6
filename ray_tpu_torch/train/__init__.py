"""ray_tpu_torch.train — distributed training library.

API parity target: `ray.train` (`python/ray/train/__init__.py` — SURVEY.md
Appendix A): report / get_context / get_checkpoint / get_dataset_shard,
Checkpoint, RunConfig / ScalingConfig / CheckpointConfig / FailureConfig,
Result, and trainers.

The port's trainer is `TorchTrainer`: one worker per card, the gang joined
in one torch.distributed world (NCCL on GPU workers, gloo on CPU workers),
and `torch_utils.get_mesh()` builds the gang-wide `DeviceMesh` the model's
`mesh=` path runs on. The reference (`ray_tpu/train/__init__.py:1-14`)
gangs one JAX worker per host instead; its GBDT trainers and `JaxTrainer`
are not ported here.
"""

from .config import (
    CheckpointConfig,
    DataConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from .checkpoint import Checkpoint
from .session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_elastic_session,
    get_streaming_ingest,
    report,
)
from .result import Result
from .base_trainer import BaseTrainer
from .data_parallel_trainer import DataParallelTrainer
# reference: GBDTTrainer, XGBoostTrainer and JaxTrainer
# (`ray_tpu/train/__init__.py:35-36`) are not ported yet.
from . import elastic  # noqa: F401 — fault-tolerant gang training
from . import huggingface  # noqa: F401 — HF checkpoint interop (GPT-2 family)
from . import torch_trainer as torch  # ray_tpu_torch.train.torch.prepare_model(...)
from .torch_trainer import TorchTrainer

__all__ = [
    "report",
    "get_context",
    "get_checkpoint",
    "get_dataset_shard",
    "get_elastic_session",
    "get_streaming_ingest",
    "elastic",
    "Checkpoint",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "CheckpointConfig",
    "FailureConfig",
    "DataConfig",
    "BaseTrainer",
    "DataParallelTrainer",
    "TorchTrainer",
    "torch",
]
