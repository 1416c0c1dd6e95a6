"""DDPG — deep deterministic policy gradient.

Reference analog: `rllib/algorithms/ddpg/ddpg.py`. The reference implements
TD3 as DDPG-plus-tricks; here the shared machinery lives in td3.py and DDPG
is the preset with the tricks OFF: single critic (use_twin_q=False), no
target-policy smoothing, no delayed policy updates.
"""

from __future__ import annotations

from .td3 import TD3, TD3Config


class DDPGConfig(TD3Config):
    def __init__(self):
        super().__init__()
        self.use_twin_q = False
        self.target_noise = 0.0
        self.noise_clip = 0.0
        self.policy_delay = 1


class DDPG(TD3):
    config_class = DDPGConfig


DDPGConfig.algo_class = DDPG
