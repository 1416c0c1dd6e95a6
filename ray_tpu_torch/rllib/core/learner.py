"""Learner / LearnerGroup (reference: `rllib/core/learner/learner.py:95`,
`rllib/core/learner/learner_group.py:71`).

The JAX reference (`ray_tpu/rllib/core/learner.py`) jits the whole update
— advantage estimation, epoch loop, minibatching, optimizer — into one XLA
program. The port runs the same update on the learner's device (None: the
card), op for op, each gradient step of an update one CUDA graph on the
card where the algorithm's update uses `optim.step_program`: params and optimizer state live there, `update` converts
the numpy batch once, runs the algorithm's update and waits for the device
once, for its metrics. The update's randomness (minibatch permutations)
comes from the learner's `torch.Generator` on that device.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ..utils.tree import to_device, to_numpy, tree_map


class Learner:
    """Holds (params, opt_state) and the algorithm's update.

    `update_fn(state, batch, gen) -> (state, metrics)` is supplied by the
    algorithm (PPO/IMPALA/DQN build different programs).
    """

    def __init__(
        self,
        module: Any,
        update_fn: Callable,
        *,
        seed: int = 0,
        mesh=None,
        batch_axis: str = "dp",
        device=None,
    ):
        if mesh is not None:
            # reference: a jax.sharding.Mesh shards the batch over dp
            # (`ray_tpu/rllib/core/learner.py:33-48`); no caller in the
            # reference's rllib passes one.
            raise NotImplementedError(
                "Learner(mesh=) is not ported yet (ROADMAP queue 1 item 4); "
                "the learner runs on one device"
            )
        self.module = module
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # Params are drawn on the CPU from the seed, then moved: the same
        # seed gives the same params on any device.
        self.params = to_device(module.init(torch.Generator().manual_seed(seed)), self.device)
        self.opt_state = None  # set by algorithm after optimizer init
        self._update = update_fn

    @property
    def state(self) -> Tuple[Any, Any]:
        return (self.params, self.opt_state)

    def set_state(self, state):
        self.params, self.opt_state = state

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Run the update on a batch; returns scalar metrics."""
        batch = to_device(batch, self.device)
        (self.params, self.opt_state), metrics = self._update(
            (self.params, self.opt_state), batch, self._gen
        )
        values = torch.stack([v.float() for v in metrics.values()]).tolist()  # one sync
        return dict(zip(metrics, values))

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)

    # --- checkpointing -------------------------------------------------
    def save_state(self) -> bytes:
        host = tree_map(lambda t: t.detach().cpu(), (self.params, self.opt_state))
        return pickle.dumps((*host, self._gen.get_state()))

    def load_state(self, blob: bytes):
        params, opt_state, gen_state = pickle.loads(blob)
        self.params, self.opt_state = to_device((params, opt_state), self.device)
        self._gen.set_state(gen_state)


class LearnerGroup:
    """Manages the learner placement (reference `learner_group.py:71` manages
    a DDP actor group; here one learner — `remote=True` places it on a
    cluster worker as an actor, a GPU worker when the learner's device is
    the card)."""

    def __init__(self, make_learner: Callable[[], Learner], *, remote: bool = False,
                 device=None):
        self._remote = remote
        if remote:
            import ray_tpu_torch

            # A CPU worker sees no card: a learner on the card needs a GPU worker.
            num_gpus = 1 if resolve_device(device).type == "cuda" else 0

            @ray_tpu_torch.remote(num_gpus=num_gpus)
            class _LearnerActor:
                def __init__(self):
                    self.learner = make_learner()

                def update(self, batch):
                    return self.learner.update(batch)

                def get_weights(self):
                    return self.learner.get_weights()

                def save_state(self):
                    return self.learner.save_state()

                def load_state(self, blob):
                    return self.learner.load_state(blob)

            self._actor = _LearnerActor.remote()
            self._ray = ray_tpu_torch
        else:
            self._learner = make_learner()

    def update(self, batch) -> Dict[str, float]:
        if self._remote:
            return self._ray.get(self._actor.update.remote(batch))
        return self._learner.update(batch)

    def get_weights(self):
        if self._remote:
            return self._ray.get(self._actor.get_weights.remote())
        return self._learner.get_weights()

    def save_state(self) -> bytes:
        if self._remote:
            return self._ray.get(self._actor.save_state.remote())
        return self._learner.save_state()

    def load_state(self, blob: bytes):
        if self._remote:
            self._ray.get(self._actor.load_state.remote(blob))
        else:
            self._learner.load_state(blob)

    def shutdown(self):
        if self._remote:
            try:
                self._ray.kill(self._actor)
            except Exception:  # noqa: BLE001
                pass

    @property
    def local_learner(self) -> Optional[Learner]:
        return None if self._remote else self._learner
