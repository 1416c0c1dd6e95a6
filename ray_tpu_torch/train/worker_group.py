"""WorkerGroup — a gang of training worker actors.

Reference analog: `python/ray/train/_internal/worker_group.py:102` — N actors
created with per-worker resources, functions pushed to all workers. Gang
placement uses a STRICT_PACK/PACK placement group like slice gangs in the
reference's TPU pod scheduling (`_private/accelerators/tpu.py:199-313`).
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

from .. import core
from ..core import api
from ..core.devices import ACCELERATOR  # the GPU resource key (the reference's "TPU")
from .session import TrainContext, get_session, init_session, shutdown_session


class TrainWorker:
    """Actor hosting one training worker (runs user fn on a thread so the
    actor stays responsive for result polling)."""

    def __init__(self, context_kwargs: Dict[str, Any]):
        self.context = TrainContext(**context_kwargs)
        self.session = init_session(self.context)
        self._thread: Optional[threading.Thread] = None
        self._collective: Optional[tuple] = None

    def set_env(self, env: Dict[str, str]):
        import os

        self.context.env_vars.update(env)
        os.environ.update(env)
        return True

    def setup_collective(self, world_size: int, rank: int, group_name: str):
        # Recorded only; the actual init happens on the loop thread in run()
        # because the group context is thread-local.
        self._collective = (world_size, rank, group_name)
        return True

    def run(self, fn_payload) -> bool:
        import cloudpickle

        from .session import bind_thread_session

        fn, config = cloudpickle.loads(fn_payload)

        def target():
            bind_thread_session(self.session)
            try:
                if self._collective is not None:
                    from .. import collective

                    world, rank, group = self._collective
                    collective.init_collective_group(world, rank, group_name=group)
                if config is not None:
                    fn(config)
                else:
                    fn()
            except BaseException as e:  # noqa: BLE001
                self.session.error = e
                self.session.error_tb = traceback.format_exc()
            finally:
                # Land any still-queued async checkpoint shards before the
                # executor can treat this worker as finished — "finished"
                # must imply "reported checkpoints are durable". close()
                # also stops the writer thread (local mode shares one
                # process across workers AND incarnations; a flush-only
                # teardown would leak one parked thread per restart).
                es = getattr(self.session, "elastic", None)
                if es is not None:
                    try:
                        es.close()
                    except Exception as ce:  # noqa: BLE001
                        # A shard that never landed is a worker failure —
                        # finishing "successfully" would let a later
                        # restore silently resume from an older step.
                        if self.session.error is None:
                            self.session.error = ce
                            self.session.error_tb = traceback.format_exc()
                self.session.finished.set()

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return True

    def poll(self, from_index=None):
        """Returns (results, finished, error_str). With `from_index` (int),
        a NON-destructive read of reports from that cursor — idempotent, so
        a response lost in flight (gang poll batch failing on a dead
        sibling) costs nothing: the caller re-polls from the same cursor.
        Without it, drain semantics (tune's tuner polls this way)."""
        # finished is read BEFORE the results snapshot: the loop thread
        # appends its last report strictly before finished.set(), so
        # finished=True here guarantees the snapshot below contains every
        # report. Snapshot-then-read would let a final report land in the
        # window and be dropped forever when the caller stops polling on
        # finished=True.
        finished = self.session.finished.is_set()
        if from_index is None:
            out = []
            while not self.session.results.empty():
                out.append(self.session.results.get())
            # Drain consumers never cursor-ack, so retire the drained
            # entries from the cursor history too — otherwise a long
            # drain-polled run (tune's tuner) retains every report and
            # in-memory checkpoint payload for the life of the worker.
            n = min(len(out), len(self.session.history))
            if n:
                del self.session.history[:n]
                self.session.history_base += n
        else:
            base = self.session.history_base
            out = list(self.session.history[max(from_index - base, 0):])
            # Implicit ack: a caller polling from N has durably consumed
            # everything below N — trim it, and discard the legacy queue
            # this consumer will never drain, so per-worker memory stays
            # bounded by one poll interval on long runs.
            if from_index > base:
                del self.session.history[: from_index - base]
                self.session.history_base = from_index
            while not self.session.results.empty():
                try:
                    self.session.results.get_nowait()
                except Exception:  # noqa: BLE001 — racing reporter, fine
                    break
        err = None
        if self.session.error is not None:
            err = f"{self.session.error!r}\n{getattr(self.session, 'error_tb', '')}"
        return out, finished, err

    def set_checkpoint(self, checkpoint):
        self.context.latest_checkpoint = checkpoint
        return True

    def execute(self, fn_payload):
        """Synchronously run a function on the worker (for utilities)."""
        import cloudpickle

        fn = cloudpickle.loads(fn_payload)
        return fn()


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        contexts: List[Dict[str, Any]],
        placement_strategy: str = "PACK",
    ):
        import cloudpickle

        self._cloudpickle = cloudpickle
        remote_cls = api.remote(TrainWorker)
        cpus = resources_per_worker.get("CPU", 1.0)
        # The GPU worker kind (core/devices.py), where the reference reads
        # "TPU" (`ray_tpu/train/worker_group.py:159-161`).
        gpus = resources_per_worker.get(ACCELERATOR, 0.0)
        extra = {
            k: v for k, v in resources_per_worker.items() if k not in ("CPU", ACCELERATOR)
        }
        # Gang placement: one bundle per worker, worker i pinned to bundle i
        # (reference: `BackendExecutor` creating the Train placement group;
        # TPU slice gangs are STRICT_PACK per `accelerators/tpu.py:199-313`).
        self._pg = None
        strategy_kwargs: List[Dict[str, Any]] = [{} for _ in range(num_workers)]
        # reference: "TPU": tpus (`ray_tpu/train/worker_group.py:168`)
        bundle = {k: v for k, v in {"CPU": cpus, ACCELERATOR: gpus, **extra}.items() if v}
        if bundle:
            from ..core.task_spec import PlacementGroupSchedulingStrategy
            from ..util.placement_group import placement_group

            try:
                pg = placement_group(
                    [dict(bundle) for _ in range(num_workers)],
                    strategy=placement_strategy,
                )
                if pg.wait(timeout_seconds=30):
                    self._pg = pg
                    strategy_kwargs = [
                        {
                            "scheduling_strategy": PlacementGroupSchedulingStrategy(
                                placement_group=pg,
                                placement_group_bundle_index=i,
                            )
                        }
                        for i in range(num_workers)
                    ]
                else:  # infeasible as a gang — fall back to free placement
                    from ..util.placement_group import remove_placement_group

                    remove_placement_group(pg)
            except Exception:  # noqa: BLE001 — backend without PG support
                self._pg = None
        self.workers = [
            remote_cls.options(
                # reference: num_tpus=tpus (`ray_tpu/train/worker_group.py:197`)
                num_cpus=cpus, num_gpus=gpus or None, resources=extra or {},
                **strategy_kwargs[i],
            ).remote(contexts[i])
            for i in range(num_workers)
        ]

    def __len__(self):
        return len(self.workers)

    def actor_ids(self) -> List[str]:
        """Hex actor ids of the gang members — the unit the supervisor
        watches for death events and chaos harnesses target for kills."""
        return [w._id.hex() for w in self.workers]

    def run_async(self, fn: Callable, config=None):
        payload = self._cloudpickle.dumps((fn, config))
        return api.get([w.run.remote(payload) for w in self.workers])

    def poll(self, cursors: Optional[List[int]] = None):
        if cursors is None:
            return api.get([w.poll.remote() for w in self.workers])
        return api.get(
            [w.poll.remote(c) for w, c in zip(self.workers, cursors)]
        )

    def execute_all(self, fn: Callable):
        payload = self._cloudpickle.dumps(fn)
        return api.get([w.execute.remote(payload) for w in self.workers])

    def execute_single(self, index: int, fn: Callable):
        payload = self._cloudpickle.dumps(fn)
        return api.get(self.workers[index].execute.remote(payload))

    def set_env_all(self, envs: List[Dict[str, str]]):
        return api.get(
            [w.set_env.remote(env) for w, env in zip(self.workers, envs)]
        )

    def setup_collective(self, group_name: str):
        refs = [
            w.setup_collective.remote(len(self.workers), i, group_name)
            for i, w in enumerate(self.workers)
        ]
        return api.get(refs, timeout=120)

    def set_checkpoint_all(self, checkpoint):
        return api.get([w.set_checkpoint.remote(checkpoint) for w in self.workers])

    def shutdown(self):
        for w in self.workers:
            try:
                api.kill(w)
            except Exception:  # noqa: BLE001
                pass
        if self._pg is not None:
            from ..util.placement_group import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001
                pass
            self._pg = None
