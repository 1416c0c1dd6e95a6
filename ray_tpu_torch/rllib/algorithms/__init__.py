from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig

__all__ = ["Algorithm", "AlgorithmConfig"]
