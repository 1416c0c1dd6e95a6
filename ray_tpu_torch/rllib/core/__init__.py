from .rl_module import RLModule, DiscretePolicyModule, GaussianPolicyModule, QModule
from .learner import Learner, LearnerGroup

__all__ = [
    "RLModule",
    "DiscretePolicyModule",
    "GaussianPolicyModule",
    "QModule",
    "Learner",
    "LearnerGroup",
]
