"""Connectors — pluggable observation/action transform pipelines.

Reference analog: `rllib/connectors/` (env-to-module and module-to-env
connector pipelines on the new API stack): preprocessing lives OUTSIDE the
model so trained policies stay deployable against raw envs.

Env-to-module connectors transform observation batches before the policy
forward; module-to-env connectors transform sampled actions before
`env.step`. Stateful connectors (e.g. running normalization) expose
`get_state`/`set_state` so evaluation and checkpointing can carry them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    def __call__(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # Stateful connectors override these (reference: connector state in
    # checkpoints).
    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]):
        pass


class ConnectorPipeline(Connector):
    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def __call__(self, data):
        for c in self.connectors:
            data = c(data)
        return data

    def get_state(self):
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if i in state or str(i) in state:
                c.set_state(state.get(i, state.get(str(i), {})))

    def __len__(self):
        return len(self.connectors)


# --------------------------------------------------------- env -> module
class FlattenObservations(Connector):
    """[N, ...] -> [N, prod(...)] (reference: `FlattenObservations`)."""

    def __call__(self, obs):
        return np.asarray(obs).reshape(len(obs), -1)


class NormalizeObservations(Connector):
    """Running mean/std normalization (reference: `MeanStdFilter`).
    Welford-style batched updates; frozen when `update=False` (evaluation)."""

    def __init__(self, clip: float = 10.0, update: bool = True, eps: float = 1e-8):
        self.clip = clip
        self.update = update
        self.eps = eps
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def __call__(self, obs):
        obs = np.asarray(obs, np.float64)
        if self.mean is None:
            self.mean = np.zeros(obs.shape[1:], np.float64)
            self.m2 = np.ones(obs.shape[1:], np.float64)
        if self.update:
            batch_count = len(obs)
            batch_mean = obs.mean(axis=0)
            batch_var = obs.var(axis=0)
            delta = batch_mean - self.mean
            total = self.count + batch_count
            self.mean = self.mean + delta * batch_count / total
            self.m2 = (
                self.m2
                + batch_var * batch_count
                + delta**2 * self.count * batch_count / total
            )
            self.count = total
        var = self.m2 / max(self.count, 1.0)
        out = (obs - self.mean) / np.sqrt(var + self.eps)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self):
        return {
            "count": self.count,
            "mean": None if self.mean is None else self.mean.copy(),
            "m2": None if self.m2 is None else self.m2.copy(),
        }

    def set_state(self, state):
        if state:
            self.count = state["count"]
            self.mean = state["mean"]
            self.m2 = state["m2"]


# --------------------------------------------------------- module -> env
class ClipActions(Connector):
    """Clip continuous actions into the env's bounds (reference:
    `module_to_env.ClipActions`)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, actions):
        return np.clip(actions, self.low, self.high)


class ScaleActions(Connector):
    """Map tanh-squashed [-1, 1] policy outputs onto [low, high]."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, actions):
        return self.low + (np.asarray(actions) + 1.0) * 0.5 * (self.high - self.low)
