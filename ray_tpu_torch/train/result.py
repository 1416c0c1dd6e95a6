"""Result object returned by Trainer.fit (reference: `python/ray/air/result.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Any] = None
    error: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    path: str = ""

    @property
    def best_checkpoints(self):
        return [self.checkpoint] if self.checkpoint else []
