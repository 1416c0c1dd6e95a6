"""BaseTrainer / DataParallelTrainer / JaxTrainer.

Reference analogs: `python/ray/train/base_trainer.py:579 fit`,
`data_parallel_trainer.py:432 training_loop`, `torch/config.py` backend.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, Optional

from .backend_executor import Backend, BackendExecutor
from .config import RunConfig, ScalingConfig
from .result import Result


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint=None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError
