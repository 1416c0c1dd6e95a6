"""Sebulba — actor/learner split over the gang + block-transport planes
(Podracer §3, arxiv 2104.06272; reference:
`ray_tpu/rllib/podracer/sebulba.py`).

Topology: N actor-gang members (each wrapping the existing numpy
`EnvRunner`, its forward on the CPU — this is the plane for Python-loop
envs; CPU actors see no card) + 1 learner member hosting the algorithm's
torch update on `config.device` (None: the card), a GPU worker
(`num_gpus=1`) when that is the card. Three data planes:

  * trajectories: each actor lands its time-major fragment as ONE arena
    object (`podracer.transport.TrajTransport` — pickle-5 frame,
    `put_serialized` span descriptors) and returns only the descriptor;
    the learner imports same-node off the arena mapping or cross-node as
    one bulk span pull;
  * parameters: the learner broadcasts weights (numpy, ≈20 KB for PPO's
    (64, 64) policy) over ONE compiled-DAG edge channel
    (`make_edge_channel`: shm seqlock same-node, TCP cross-node) with a
    reader slot per actor — depth-1 backpressure means a broadcast returns
    only after every actor acked the previous one;
  * control: plain actor RPCs, sliced short so the driver consults the
    GangSupervisor between waits.

Elasticity (the elastic training layer): the supervisor watches all N+1 members
through the controller death feed; any member death aborts the whole gang
within the failure deadline, then restart policy + backoff + RESHAPE — the
actor count is re-picked from currently-feasible capacity within
[min_actors, num_actors], the learner restores from the driver-cached state
blob, and the global step counter continues where it left off. The blob
holds the params and optimizer state as CPU tensors and the learner
generator's state, so a respawned learner, a fresh GPU worker included,
restores from it.
"""

from __future__ import annotations

import logging
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ...dag.compiled import ChannelHostMixin

logger = logging.getLogger(__name__)


class SebulbaGangError(RuntimeError):
    pass


class _ActorMember(ChannelHostMixin):
    """Gang actor: one EnvRunner + the trajectory publish side."""

    def __init__(self, payload: bytes):
        import cloudpickle

        import torch

        o = cloudpickle.loads(payload)
        from ..env.env_runner import EnvRunner
        from .transport import TrajTransport

        # The member holds one CPU (`num_cpus=1`): one torch thread for its
        # forward, not one per core of the host (8 threads on 8 cores made a
        # 32 x 128 fragment 10x slower than one).
        torch.set_num_threads(1)

        self._runner = EnvRunner(
            env_name=o["env_name"],
            num_envs=o["num_envs"],
            module=o["module"],
            rollout_len=o["rollout_len"],
            seed=o["seed"],
            env_kwargs=o["env_kwargs"],
            device="cpu",
        )
        self._transport = TrajTransport(
            inline_max_bytes=o["inline_max_bytes"],
            timeout_s=o["channel_timeout_s"],
        )
        self._timeout_s = o["channel_timeout_s"]
        self._param_reader = None
        self._params = None

    def ping(self) -> str:
        return "ok"

    def pid(self) -> int:
        import os

        return os.getpid()

    def bind_param_channel(self, reader) -> str:
        self._param_reader = reader
        return "ok"

    def collect(self, sync: bool) -> Dict[str, Any]:
        """One fragment: (optionally) receive fresh params off the broadcast
        channel, roll the envs, publish the batch, return the descriptor."""
        if sync:
            self._params = self._param_reader.begin_read(
                timeout=self._timeout_s
            )
            self._param_reader.end_read()
        if self._params is None:
            raise RuntimeError(
                "collect(sync=False) before any parameter broadcast"
            )
        batch = self._runner.sample(self._params)
        episode_returns = batch.pop("episode_returns")
        episode_lengths = batch.pop("episode_lengths")
        from ...util import flight

        t0 = flight.now_ns()
        desc = self._transport.publish(batch)
        flight.record("sebulba.publish", t0, flight.now_ns(),
                      lane="rl/actor", attrs={"frames": len(batch)})
        # Cluster-clock publish stamp: the learner turns the gap between
        # this and its fetch into an actor->learner queue-wait span.
        desc = dict(desc)
        desc["published_at"] = flight.cluster_time()
        return {
            "desc": desc,
            "episode_returns": episode_returns,
            "episode_lengths": episode_lengths,
            "transport": dict(self._transport.stats),
        }


class _LearnerMember(ChannelHostMixin):
    """Gang actor hosting the update on its device (each minibatch step one
    CUDA graph on the card) + the broadcast side."""

    def __init__(self, payload: bytes):
        import cloudpickle
        import torch

        from ...device import resolve_device
        from ..utils.tree import to_device

        o = cloudpickle.loads(payload)
        from .transport import TrajTransport

        self._module = o["module"]
        self._opt = o["opt"]
        self._update = o["update_fn"]
        self.device = resolve_device(o["device"])
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(o["seed"])
        if o.get("state_blob") is not None:
            params, opt_state, gen_state = pickle.loads(o["state_blob"])
            self._gen.set_state(gen_state)
            params, opt_state = to_device((params, opt_state), self.device)
        else:
            params = to_device(o["init_params"], self.device)
            opt_state = self._opt.init(params)
        self._state = (params, opt_state)
        self._transport = TrajTransport(timeout_s=o["channel_timeout_s"])
        self._chan = None

    def ping(self) -> str:
        return "ok"

    def device_name(self) -> str:
        """The device the update runs on ("cuda" in a GPU worker)."""
        return self.device.type

    def bind_param_channel(self, chan) -> str:
        self._chan = chan
        return "ok"

    def broadcast(self, timeout_s: float = 60.0) -> str:
        """Write current weights to every actor's reader slot. Returns after
        the channel accepted the write — which, at depth 1, also proves
        every actor acked the PREVIOUS broadcast."""
        self._chan.write(self.get_weights(), timeout=timeout_s)
        return "ok"

    def update(self, descs: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Import every actor's fragment (arena/bulk rungs), concat along
        the env axis, move it to the learner's device once, run the
        update."""
        import torch

        from ...util import flight
        from ..utils.tree import to_device

        self._gauge_queue_depth(len(descs))
        # Queue-wait spans: published_at is the actor's cluster-clock stamp
        # (both ends clock-aligned at registration), so the span length IS
        # the time the fragment sat between the gangs — the latency the
        # rllib_actor_learner_queue_depth gauge only counts.
        fetch_t = flight.cluster_time()
        batches = []
        for d in descs:
            d = dict(d)
            pub = d.pop("published_at", None)
            if pub is not None and flight.enabled():
                wait = max(fetch_t - pub, 0.0)
                t1 = flight.now_ns()
                flight.record("sebulba.queue_wait",
                              t1 - int(wait * 1e9), t1,
                              lane="rl/learner", attrs={"depth": len(descs)})
            t0 = flight.now_ns()
            batches.append(self._transport.fetch(d))
            flight.record("sebulba.import", t0, flight.now_ns(),
                          lane="rl/learner")
        if len(batches) == 1:
            batch = batches[0]
        else:
            batch = {
                k: np.concatenate(
                    [b[k] for b in batches],
                    axis=0 if k == "last_obs" else 1,
                )
                for k in batches[0]
            }
        self._gauge_queue_depth(0)
        t0 = time.perf_counter()
        self._state, metrics = self._update(self._state, to_device(batch, self.device), self._gen)
        values = torch.stack([v.float() for v in metrics.values()]).tolist()  # one sync
        metrics = dict(zip(metrics, values))
        dt = time.perf_counter() - t0
        T, B = batches[0]["rewards"].shape[0], sum(
            b["rewards"].shape[1] for b in batches
        )
        self._observe(T * B, dt)
        return {
            "metrics": metrics,
            "env_steps": T * B,
            "learner_step_seconds": dt,
            "state": self.save_state(),
            "transport": dict(self._transport.stats),
        }

    def get_weights(self):
        from ..utils.tree import to_numpy

        return to_numpy(self._state[0])

    def save_state(self) -> bytes:
        from ..utils.tree import tree_map

        params, opt_state = tree_map(lambda t: t.detach().cpu(), self._state)
        return pickle.dumps(
            (params, opt_state, self._gen.get_state())
        )

    def _gauge_queue_depth(self, depth: int):
        try:
            from ...util.metrics import rllib_metrics

            rllib_metrics()["rllib_actor_learner_queue_depth"].set(
                depth, tags={"plane": "sebulba"}
            )
        except Exception:  # noqa: BLE001 — metrics never load-bearing
            pass

    def _observe(self, env_steps: int, dt: float):
        try:
            from .anakin import _observe_metrics

            _observe_metrics("sebulba", env_steps, dt)
        except Exception:  # noqa: BLE001
            pass


class _SebulbaGang:
    """Supervisor-facing shim: N actor members + the learner + the channel."""

    def __init__(self, actors, learner, channel):
        self.actors = actors
        self.learner = learner
        self.channel = channel

    def actor_ids(self) -> List[str]:
        return [a._id.hex() for a in self.actors + [self.learner]]

    def shutdown(self):
        from ...core import api

        for a in self.actors + [self.learner]:
            try:
                api.kill(a)
            except Exception:  # noqa: BLE001
                pass
        if self.channel is not None:
            try:
                self.channel.destroy()
            except Exception:  # noqa: BLE001
                pass


class SebulbaDriver:
    """The Sebulba execution plane behind `Algorithm`."""

    plane = "sebulba"

    def __init__(self, algo):
        import ray_tpu_torch

        cfg = algo.config
        self.algo = algo
        self.cfg = cfg
        self.num_actors = int(cfg.podracer_num_actors)
        from ...device import resolve_device

        # The learner's device: a learner on the card is a GPU worker.
        self.device = resolve_device(cfg.device)
        self._num_gpus = 1 if self.device.type == "cuda" else 0
        if not ray_tpu_torch.is_initialized():
            # Actors + learner each ask for one CPU; an auto-booted local
            # cluster defaults to CPU=1 and would never place the gang.
            # A learner on the card needs the cluster's GPU as well.
            ray_tpu_torch.init(
                ignore_reinit_error=True, num_cpus=self.num_actors + 2,
                num_gpus=self._num_gpus or None,
            )
        self._ray = ray_tpu_torch
        self.rollout_len = int(cfg.derived_podracer_rollout_len())
        self._broadcast_interval = max(1, int(cfg.podracer_broadcast_interval))
        self._step_timeout_s = 120.0
        self._iters_since_spawn = 0
        self._state_blob: Optional[bytes] = None  # reshape restore point
        self._weights = None
        self.gang: Optional[_SebulbaGang] = None
        self.transport_stats: Dict[str, Dict[str, int]] = {}

        from ...train.config import FailureConfig, ScalingConfig
        from ...train.elastic import GangSupervisor

        self._supervisor = GangSupervisor(
            ScalingConfig(
                num_workers=self.num_actors + 1,
                min_workers=int(cfg.podracer_min_actors) + 1,
                max_workers=self.num_actors + 1,
                resources_per_worker={"CPU": 1},
            ),
            FailureConfig(max_failures=int(cfg.podracer_max_restarts)),
            experiment_name=f"sebulba-{cfg.env}",
        )
        self._spawn(self.num_actors)

    # -------------------------------------------------------------- spawn
    def _spawn(self, n_actors: int):
        import cloudpickle
        import torch

        from ...core import api
        from ..utils.tree import to_numpy
        from ...core.runtime_context import get_runtime_context
        from ...dag.compiled import make_edge_channel

        cfg = self.cfg
        algo = self.algo
        opt, update_fn = algo._podracer_update_factory(axis_name=None)
        init_params = (
            self._weights if self._weights is not None
            else to_numpy(algo.module.init(
                torch.Generator().manual_seed(cfg.seed)
            ))
        )
        learner_payload = cloudpickle.dumps(dict(
            module=algo.module, opt=opt, update_fn=update_fn,
            seed=cfg.seed, init_params=init_params, device=str(self.device),
            state_blob=self._state_blob, channel_timeout_s=60.0,
        ))
        RemoteLearner = api.remote(_LearnerMember)
        learner = RemoteLearner.options(
            num_cpus=1, num_gpus=self._num_gpus
        ).remote(learner_payload)

        RemoteActor = api.remote(_ActorMember)
        actors = []
        for i in range(n_actors):
            payload = cloudpickle.dumps(dict(
                env_name=cfg.env, env_kwargs=cfg.env_config,
                num_envs=cfg.podracer_envs_per_actor,
                module=algo.module, rollout_len=self.rollout_len,
                seed=cfg.seed + 1 + i,
                inline_max_bytes=64 * 1024, channel_timeout_s=60.0,
            ))
            actors.append(RemoteActor.options(num_cpus=1).remote(payload))

        try:
            # ONE broadcast channel: producer = learner, a reader slot per
            # actor (shm when colocated, TCP across nodes).
            driver_node = get_runtime_context().get_node_id()
            nodes = api.get(
                [a.node_id.remote() for a in [learner] + actors],
                timeout=self._step_timeout_s,
            )
            channel = make_edge_channel(
                1 << 20, nodes[0], nodes[1:], n_actors, learner, driver_node
            )
            binds = [learner.bind_param_channel.remote(channel)]
            binds += [
                a.bind_param_channel.remote(channel.with_reader_slot(i))
                for i, a in enumerate(actors)
            ]
            api.get(binds, timeout=self._step_timeout_s)
        except Exception as e:  # noqa: BLE001 — a member died mid-setup
            gang = _SebulbaGang(actors, learner, None)
            gang.shutdown()
            raise SebulbaGangError(f"gang setup failed: {e!r}") from e

        self.gang = _SebulbaGang(actors, learner, channel)
        self.num_actors = n_actors
        self._iters_since_spawn = 0
        self._supervisor.watch(self.gang)
        if self._weights is None:
            self._weights = api.get(
                learner.get_weights.remote(), timeout=self._step_timeout_s
            )

    # ----------------------------------------------------------- training
    def training_step(self) -> Dict[str, Any]:
        """One iteration, elastically: on a gang failure mid-iteration the
        gang is aborted, reshaped, respawned from the last learner state,
        and the iteration RETRIED — one train() call survives member death
        (the chaos test kills an actor here)."""
        recovery_t0 = None
        while True:
            try:
                result = self._one_iteration()
                if recovery_t0 is not None:
                    self._supervisor.record_recovery(
                        time.monotonic() - recovery_t0
                    )
                return result
            except SebulbaGangError as e:
                if recovery_t0 is None:
                    recovery_t0 = time.monotonic()
                self._supervisor.abort_mesh(self.gang)
                self.gang = None
                decision = self._supervisor.on_failure(str(e))
                if decision.stop:
                    raise RuntimeError(
                        f"sebulba gang failed permanently after "
                        f"{self._supervisor.attempts} attempt(s): {e}"
                    ) from e
                logger.warning(
                    "sebulba gang failure (%s) — restart %d after %.1fs",
                    e, self._supervisor.attempts, decision.backoff_s,
                )
                if decision.backoff_s > 0:
                    time.sleep(decision.backoff_s)
                world = self._supervisor.plan_world_size()
                lo = int(self.cfg.podracer_min_actors)
                hi = int(self.cfg.podracer_num_actors)
                n = max(lo, min(hi, (world or hi + 1) - 1))
                if n != self.num_actors:
                    logger.warning(
                        "sebulba reshapes: %d -> %d actors",
                        self.num_actors, n,
                    )
                self._spawn(n)

    def _one_iteration(self) -> Dict[str, Any]:
        from ...core import api

        self._check_failure()
        gang = self.gang
        # Always sync on the first iteration after a (re)spawn — fresh
        # actors have no weights until a broadcast lands.
        sync = (
            self._iters_since_spawn == 0
            or self._iters_since_spawn % self._broadcast_interval == 0
        )
        if sync:
            bref = gang.learner.broadcast.remote(self._step_timeout_s)
        crefs = [a.collect.remote(sync) for a in gang.actors]
        if sync:
            self._get([bref])
        outs = self._get(crefs)
        for o in outs:
            rets = list(o["episode_returns"])
            self.algo._episode_returns.extend(rets)
            self.algo._episode_lengths.extend(list(o["episode_lengths"]))
            self.algo._episodes_this_iter += len(rets)
        self.transport_stats["actors"] = [o["transport"] for o in outs]

        descs = [o["desc"] for o in outs]
        (up,) = self._get([gang.learner.update.remote(descs)])
        self._weights = None  # invalidated; refetched lazily
        self._state_blob = up["state"]
        self.transport_stats["learner"] = up["transport"]
        self._iters_since_spawn += 1
        return {
            "_env_steps_this_iter": up["env_steps"],
            "info": {
                "learner": up["metrics"],
                "learner_step_seconds": up["learner_step_seconds"],
                "num_actors": self.num_actors,
            },
        }

    def _check_failure(self):
        reason = self._supervisor.failure()
        if reason:
            raise SebulbaGangError(f"gang member died ({reason})")

    def _get(self, refs):
        """api.get in SHORT slices, consulting the supervisor between them
        (the MPMD trainer's pattern): a death detected through the
        controller feed aborts within the poll window instead of waiting
        out a full RPC deadline on members that will never answer."""
        from ...core import api
        from ...core.exceptions import GetTimeoutError

        deadline = time.monotonic() + self._step_timeout_s
        while True:
            self._check_failure()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise SebulbaGangError(
                    f"step timed out after {self._step_timeout_s:.0f}s"
                )
            try:
                return api.get(refs, timeout=min(2.0, remaining))
            except GetTimeoutError:
                continue
            except Exception as e:  # noqa: BLE001 — a member died
                raise SebulbaGangError(f"step failed: {e!r}") from e

    # ------------------------------------------------------------ weights
    def get_weights(self):
        if self._weights is None:
            if self._state_blob is not None:
                self._weights = _blob_weights(self._state_blob)
            else:
                self._weights = self._get(
                    [self.gang.learner.get_weights.remote()]
                )[0]
        return self._weights

    # ----------------------------------------------------------- persist
    def save_state(self) -> bytes:
        if self._state_blob is None:
            (self._state_blob,) = self._get(
                [self.gang.learner.save_state.remote()]
            )
        return self._state_blob

    def load_state(self, blob: bytes):
        self._state_blob = blob
        self._weights = _blob_weights(blob)
        # Restore by respawning the learner side from the blob — the same
        # path a reshape takes, so it is exercised constantly.
        if self.gang is not None:
            self._supervisor.stop_watch()
            self.gang.shutdown()
        self._spawn(self.num_actors)

    def stop(self):
        self._supervisor.stop_watch()
        if self.gang is not None:
            self.gang.shutdown()
            self.gang = None


def _blob_weights(blob: bytes):
    """The params of a learner state blob (CPU tensors) as numpy."""
    from ..utils.tree import to_numpy

    return to_numpy(pickle.loads(blob)[0])
