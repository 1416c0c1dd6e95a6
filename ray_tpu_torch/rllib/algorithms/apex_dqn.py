"""Ape-X DQN: distributed prioritized replay feeding a central learner.

Reference analog: `rllib/algorithms/apex_dqn/apex_dqn.py:1` — rollout
workers push fragments into SHARDED prioritized replay actors; the learner
pulls prioritized minibatches, updates, writes new TD priorities back, and
broadcasts weights. Redesign on this runtime: sampling overlaps the
previous learner update (the refs for round N+1 are in flight while round
N trains). The learner runs on `config.device` (None: the card), the
runners and the replay shards are CPU actors; the new priorities' TD
errors are computed in torch on the learner's device (the JAX reference,
`ray_tpu/rllib/algorithms/apex_dqn.py:160-176`, in jnp).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .dqn import DQN, DQNConfig


class ApexDQNConfig(DQNConfig):
    def __init__(self):
        super().__init__()
        self.num_replay_shards: int = 2
        self.num_env_runners = 2          # apex is distributed by definition
        self.priority_alpha: float = 0.6
        self.priority_beta: float = 0.4

    def validate(self):
        super().validate()
        if self.num_env_runners < 1:
            raise ValueError("apex-DQN needs remote env runners (>=1)")


class ReplayShard:
    """One prioritized replay shard (hosted as an actor). Reference analog:
    the replay actors Ape-X shards experience across."""

    def __init__(self, capacity: int, obs_dim: int, alpha: float,
                 beta: float, seed: int = 0):
        from ..utils.replay_buffers import PrioritizedReplayBuffer

        self._buf = PrioritizedReplayBuffer(capacity, obs_dim, alpha=alpha)
        self._beta = beta
        self._rng = np.random.default_rng(seed)

    def add_fragment(self, batch) -> int:
        self._buf.add_fragment(batch)
        return self._buf.size

    def size(self) -> int:
        return self._buf.size

    def sample(self, k: int, mb: int):
        """k minibatches of size mb + their indices (for priority updates)."""
        out = self._buf.sample(self._rng, k, mb, beta=self._beta)
        indices = out.pop("indices")
        return out, indices

    def update_priorities(self, indices, td_errors):
        self._buf.update_priorities(indices, td_errors)
        return True


class ApexDQN(DQN):
    config_class = ApexDQNConfig

    def setup(self):
        super().setup()
        import ray_tpu_torch

        cfg = self.config
        obs_dim = int(np.prod(self.observation_space.shape))
        Shard = ray_tpu_torch.remote(num_cpus=0)(ReplayShard)
        self._shards = [
            Shard.remote(
                cfg.replay_buffer_capacity // cfg.num_replay_shards,
                obs_dim, cfg.priority_alpha, cfg.priority_beta,
                seed=(cfg.seed or 0) + i,
            )
            for i in range(cfg.num_replay_shards)
        ]
        self._ray = ray_tpu_torch
        self._next_rr = 0                # round-robin shard cursor
        self._inflight_samples: List = []  # pipelined runner sample refs

    # DQN's single-process buffer is unused — fragments live in the shards.
    def training_step(self) -> Dict:
        cfg = self.config
        ray = self._ray
        self._weights = dict(self._weights)
        self._weights["eps"] = np.asarray(self._epsilon(), np.float32)

        # Pipelining: consume the PREVIOUS round's in-flight samples and
        # immediately launch the next round before training (the reference's
        # always-on sampling actors, collapsed to one outstanding round).
        w_ref = ray.put(self._weights)
        launched = [r.sample.remote(w_ref) for r in self._remote_runners]
        if self._inflight_samples:
            sample_refs, self._inflight_samples = self._inflight_samples, launched
        else:
            # First round: consume what we just launched and prime the
            # pipeline with a second in-flight round so every later step
            # overlaps sampling with the learner update.
            sample_refs = launched
            self._inflight_samples = [
                r.sample.remote(w_ref) for r in self._remote_runners
            ]

        env_steps = 0
        push_acks = []
        for ref in sample_refs:
            # Stats must come out driver-side; the payload then ships
            # driver→shard (one hop; runner→shard direct would lose the
            # episode stats the driver owns).
            b = ray.get(ref)
            returns = b.pop("episode_returns").tolist()
            self._episodes_this_iter += len(returns)
            self._episode_returns.extend(returns)
            self._episode_lengths.extend(b.pop("episode_lengths").tolist())
            T, B = b["rewards"].shape
            env_steps += T * B
            shard = self._shards[self._next_rr % len(self._shards)]
            self._next_rr += 1
            push_acks.append(shard.add_fragment.remote(b))
        ray.get(push_acks)
        # Gate on ACTUAL shard occupancy, not this step's push acks: round-
        # robin fills shards unevenly early on, and sampling an empty shard
        # is a 0/0 priority normalization.
        shard_sizes = ray.get([s.size.remote() for s in self._shards])
        ready = [
            s for s, sz in zip(self._shards, shard_sizes)
            if sz >= cfg.minibatch_size
        ]

        metrics: Dict = {"td_loss": float("nan"), "q_mean": float("nan")}
        if sum(shard_sizes) >= cfg.learning_starts and ready:
            per_shard = max(1, cfg.num_grad_steps // len(ready))
            sample_out = ray.get([
                s.sample.remote(per_shard, cfg.minibatch_size)
                for s in ready
            ])
            prio_acks = []
            for shard, (mbs, indices) in zip(ready, sample_out):
                metrics = self.learner_group.update(mbs)
                self._weights = self.learner_group.get_weights()
                # New priorities: |TD error| recomputed from the fresh net.
                td = self._td_errors(mbs)
                prio_acks.append(
                    shard.update_priorities.remote(
                        indices.reshape(-1), td.reshape(-1)
                    )
                )
            self._weights = dict(self._weights)
            self._weights["eps"] = np.asarray(self._epsilon(), np.float32)
            ray.get(prio_acks)
        return {"_env_steps_this_iter": env_steps, "info": {"learner": metrics}}

    def _td_errors(self, mbs) -> np.ndarray:
        """|TD| per transition under the CURRENT params (k, mb) -> flat,
        computed in torch on the learner's device (the reference's jnp at
        `apex_dqn.py:162`). The target takes the target net's max
        (`:175`), not double-Q."""
        from ...device import resolve_device
        from ..utils.tree import to_device

        device = resolve_device(self.config.device)
        params = to_device(self.learner_group.get_weights(), device)
        q = self.module.q
        gamma = self.config.gamma
        obs, nxt, act, rew, done = to_device(
            [mbs[k] for k in ("obs", "next_obs", "actions", "rewards", "dones")], device
        )
        with torch.no_grad():
            qv = q.forward(params["online"], obs.reshape(-1, obs.shape[-1]))
            qn = q.forward(params["target"], nxt.reshape(-1, nxt.shape[-1]))
            q_taken = torch.gather(qv, -1, act.reshape(-1).long()[:, None])[:, 0]
            td = rew.reshape(-1) + gamma * (1.0 - done.reshape(-1)) * qn.max(dim=-1).values - q_taken
        return torch.abs(td).to(torch.float32).cpu().numpy()

    def stop(self):
        for s in getattr(self, "_shards", []):
            try:
                self._ray.kill(s)
            except Exception:  # noqa: BLE001
                pass
        self._shards = []
        super().stop()


ApexDQNConfig.algo_class = ApexDQN
