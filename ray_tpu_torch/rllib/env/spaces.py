"""Minimal observation/action space descriptions (gymnasium-shaped)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


class Space:
    pass


@dataclass(frozen=True)
class Discrete(Space):
    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def dtype(self):
        return np.int32


@dataclass(frozen=True)
class Box(Space):
    low: float
    high: float
    shape: Tuple[int, ...]

    @property
    def dtype(self):
        return np.float32
