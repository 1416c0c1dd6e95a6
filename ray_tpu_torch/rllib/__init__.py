"""ray_tpu_torch.rllib — reinforcement learning library (reference: `rllib/`).

The port of the JAX reference's RLlib (`ray_tpu/rllib/__init__.py:1-14`,
the redesign of RLlib's new API stack: `rllib/core/learner/learner.py:95`,
`rllib/core/rl_module/rl_module.py:228`, `rllib/env/env_runner.py:15`):

* **EnvRunner** actors vectorize environments in numpy and run the policy
  forward pass in torch, one call per vectorized step, on the runner's
  device — the card for the local runner, the CPU for remote runners.
* **Learner** updates run on the learner's device (the card): advantage
  estimation, minibatch permutation, the epoch loop and the optimizer, op
  for op the reference's jitted program.

This slice ports PPO and multi-agent PPO with the env API, the runners,
connectors, offline data and replay buffers; the reference's other
algorithms and its podracer planes are not ported yet (ROADMAP queue 1
item 2, slices 4b and 4c).
"""

from .algorithms.algorithm import Algorithm
from .algorithms.algorithm_config import AlgorithmConfig
from .algorithms.ppo import PPO, PPOConfig
# reference: IMPALA, DQN, SAC, APPO, BC, MARWIL, TD3, DDPG, A2C, ApexDQN, CQL
# and DT (`ray_tpu/rllib/__init__.py:20-31`) are not ported yet (slice 4b).
from .algorithms.multi_agent_ppo import MultiAgentPPO, MultiAgentPPOConfig
# reference: DreamerV3 (`:33`, slice 4b) and `from . import podracer` (`:35`, slice 4c).
from . import connectors
from . import offline
from .env import register_env, make_env
from .env.env_runner import EnvRunner
from .env.multi_agent import MultiAgentEnv, SharedPolicyVectorEnv, make_multi_agent
from .utils import replay_buffers

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "PPO",
    "PPOConfig",
    # reference: the other algorithms' names (`ray_tpu/rllib/__init__.py:42-72`), slice 4b.
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "connectors",
    "offline",
    # reference: "podracer" (`:75`), slice 4c.
    "register_env",
    "make_env",
    "EnvRunner",
    "MultiAgentEnv",
    "SharedPolicyVectorEnv",
    "make_multi_agent",
    "replay_buffers",
]
