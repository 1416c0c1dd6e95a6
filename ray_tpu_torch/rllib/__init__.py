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

The port has PPO and multi-agent PPO with the env API, the runners,
connectors, offline data and replay buffers, and the discrete-action
algorithms (IMPALA, DQN, APPO, BC, MARWIL, A2C, Ape-X DQN, CQL); SAC, TD3,
DDPG, DT and DreamerV3 (slice 4b-ii) and the podracer planes (slice 4c)
are not ported yet (ROADMAP queue 1).
"""

from .algorithms.algorithm import Algorithm
from .algorithms.algorithm_config import AlgorithmConfig
from .algorithms.ppo import PPO, PPOConfig
from .algorithms.impala import IMPALA, IMPALAConfig
from .algorithms.dqn import DQN, DQNConfig
# reference: SAC (`ray_tpu/rllib/__init__.py:22`) is not ported yet (slice 4b-ii).
from .algorithms.appo import APPO, APPOConfig
from .algorithms.bc import BC, BCConfig
from .algorithms.marwil import MARWIL, MARWILConfig
# reference: TD3 and DDPG (`:26-27`) are not ported yet (slice 4b-ii).
from .algorithms.a2c import A2C, A2CConfig
from .algorithms.apex_dqn import ApexDQN, ApexDQNConfig
from .algorithms.cql import CQL, CQLConfig
# reference: DT (`:31`) is not ported yet (slice 4b-ii).
from .algorithms.multi_agent_ppo import MultiAgentPPO, MultiAgentPPOConfig
# reference: DreamerV3 (`:33`, slice 4b-ii) and `from . import podracer` (`:35`, slice 4c).
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
    "IMPALA",
    "IMPALAConfig",
    "DQN",
    "DQNConfig",
    # reference: "SAC", "SACConfig" (`ray_tpu/rllib/__init__.py:50-51`), slice 4b-ii.
    "APPO",
    "APPOConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    # reference: "TD3", "TD3Config", "DDPG", "DDPGConfig" (`:58-61`), slice 4b-ii.
    "A2C",
    "A2CConfig",
    "ApexDQN",
    "ApexDQNConfig",
    "CQL",
    "CQLConfig",
    # reference: "DT", "DTConfig", "DreamerV3", "DreamerV3Config" (`:68-69`, `:71-72`), slice 4b-ii.
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
