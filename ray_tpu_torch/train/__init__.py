"""ray_tpu_torch.train — distributed training library.

API parity target: `ray.train` (`python/ray/train/__init__.py` — SURVEY.md
Appendix A): report / get_context / get_checkpoint / get_dataset_shard,
Checkpoint, RunConfig / ScalingConfig / CheckpointConfig / FailureConfig,
Result, and trainers.

The port's trainer is `TorchTrainer`: one worker per card, the gang joined
in one torch.distributed world (NCCL on GPU workers, gloo on CPU workers),
and `torch_utils.get_mesh()` builds the gang-wide `DeviceMesh` the model's
`mesh=` path runs on. The reference (`ray_tpu/train/__init__.py:1-14`)
gangs one JAX worker per host instead; its `JaxTrainer` is `TorchTrainer`
here. The GBDT trainers fit the port's booster on a GPU worker's card.
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
from .gbdt_trainer import GBDTTrainer, XGBoostTrainer
# reference: `from .jax_trainer import JaxTrainer` (`ray_tpu/train/__init__.py:36`);
# the port's trainer is TorchTrainer.
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
    "GBDTTrainer",
    "XGBoostTrainer",
    # reference: "JaxTrainer" (`ray_tpu/train/__init__.py:61`)
    "TorchTrainer",
    "torch",
]
