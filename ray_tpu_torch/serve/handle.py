"""DeploymentHandle + Router (reference: `serve/handle.py:827,894`,
`serve/_private/router.py:924` Router, `:295` PowerOfTwoChoicesReplicaScheduler).

The router lives client-side (in whichever process holds the handle):
prefix-affinity placement for LLM prompts (the fleet plane — see
`serve/fleet/routing.py`: the prompt's leading full KV blocks hash to a
routing key matched against each replica's piggybacked hot-prefix digest,
with rendezvous fallback for cold prefixes and power-of-two fallback under
load skew), plain power-of-two-choices over per-replica outstanding counts
otherwise, periodic snapshot refresh from the controller, and router-side
batch formation for `@serve.batch` methods (one replica call per formed
batch — one XLA program per batch on TPU replicas). Unary calls fail over
ONCE to a different replica when the picked one died between refreshes.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..util import flight, tracing

_ROUTER_REFRESH_S = 1.0

# Routing-key block size used before any replica telemetry reveals the
# engine's real one (matches EngineOptions.block_size's default).
_DEFAULT_ROUTING_BLOCK = 16
# Bound on the prefill leg of a disagg handoff (prefill + first token is
# bounded work, unlike decode): a replica whose engine WEDGES without dying
# raises nothing, and an unbounded get here would pin a handoff-pool thread
# forever — 32 such requests would starve every disagg call on this router.
# On timeout the request falls back to colocated recompute (greedy-identical);
# matches the core plane's 300s stream timeout.
_PREFILL_HANDOFF_TIMEOUT_S = 300.0


def _is_replica_failure(e: BaseException) -> bool:
    """True for infrastructure failures (replica killed/crashed between
    router refreshes) — retryable on another replica; user-code exceptions
    are not."""
    try:
        from ..core.exceptions import (
            ActorDiedError,
            ActorUnavailableError,
            TaskError,
            WorkerCrashedError,
        )
    except Exception:  # noqa: BLE001
        return False
    kinds = (ActorDiedError, ActorUnavailableError, WorkerCrashedError)
    if isinstance(e, kinds):
        return True
    return isinstance(e, TaskError) and isinstance(
        getattr(e, "cause", None), kinds
    )


def _routing_prompt(args, kwargs) -> Optional[List[int]]:
    """Best-effort token-id prompt extraction for prefix-affinity routing:
    `generate(prompt, ...)` style calls carry it as the first positional or
    a `prompt=` kwarg; HTTP ingress carries it in the request body. Returns
    None (→ load-based routing) for anything that doesn't look like token
    ids — routing must never fail a call."""
    p = kwargs.get("prompt")
    if p is None and args:
        a0 = args[0]
        if isinstance(a0, (list, tuple)):
            p = a0
        else:
            j = getattr(a0, "json", None)  # HTTP Request-like
            if callable(j):
                try:
                    body = j()
                    if isinstance(body, dict):
                        p = body.get("prompt")
                except Exception:  # noqa: BLE001
                    p = None
    if isinstance(p, (list, tuple)) and p and not isinstance(
        p[0], (str, bytes, list, tuple, dict)
    ):
        try:
            int(p[0])
        except (TypeError, ValueError):
            return None
        return list(p)
    return None


class DeploymentResponse:
    """Future-like result of `handle.method.remote()` (reference
    `serve/handle.py` DeploymentResponse)."""

    def __init__(self, ref=None, future=None, on_done=None, retry=None):
        self._ref = ref
        self._future = future
        self._on_done = on_done
        # One-shot failover: on a REPLICA failure (not a user exception),
        # re-route the call through the router once (`Router.call` wires
        # this up for unary calls).
        self._retry = retry

    def result(self, timeout_s: Optional[float] = None):
        import ray_tpu_torch

        try:
            if self._future is not None:
                ref = self._future.result(timeout_s)
                if isinstance(ref, Exception):
                    raise ref
                return ref
            return ray_tpu_torch.get(self._ref, timeout=timeout_s)
        except Exception as e:  # noqa: BLE001
            retry, self._retry = self._retry, None
            if retry is not None and _is_replica_failure(e):
                return retry(timeout_s)
            raise
        finally:
            if self._on_done is not None:
                self._on_done()
                self._on_done = None

    def __del__(self):
        # Fire-and-forget callers never invoke result(); release the
        # router's outstanding-count slot when the response is dropped.
        if self._on_done is not None:
            try:
                self._on_done()
            except Exception:  # noqa: BLE001
                pass

    def _to_object_ref(self):
        if self._ref is None:
            raise RuntimeError("Batched responses have no single ObjectRef")
        return self._ref


class DeploymentResponseGenerator:
    """Iterate chunks of a streaming deployment call (reference:
    `serve.handle.DeploymentResponseGenerator`). `direct_gen` carries an
    already-materialized chunk generator instead of an ObjectRef stream —
    the disaggregated handoff path yields tokens from two replicas'
    streams behind one facade."""

    def __init__(self, ref_generator, on_done=None, direct_gen=None):
        self._gen = ref_generator
        self._on_done = on_done
        self._direct = direct_gen

    def __iter__(self):
        import ray_tpu_torch

        try:
            if self._direct is not None:
                yield from self._direct
                return
            for ref in self._gen:
                yield ray_tpu_torch.get(ref)
        finally:
            if self._on_done is not None:
                self._on_done()
                self._on_done = None


class _Batcher:
    """Router-side batch former for one (deployment, method)."""

    def __init__(self, router: "Router", method: str, max_batch_size: int, wait_s: float):
        self.router = router
        self.method = method
        self.max_batch_size = max_batch_size
        self.wait_s = wait_s
        self._lock = threading.Lock()
        self._pending: List[Tuple[Any, Any, str]] = []  # (arg, Future, model_id)
        self._timer: Optional[threading.Timer] = None

    def submit(self, arg: Any, model_id: str):
        from concurrent.futures import Future

        fut = Future()
        flush_now = False
        with self._lock:
            self._pending.append((arg, fut, model_id))
            if len(self._pending) >= self.max_batch_size:
                flush_now = True
            elif self._timer is None:
                self._timer = threading.Timer(self.wait_s, self._flush)
                self._timer.daemon = True
                self._timer.start()
        if flush_now:
            self._flush()
        return DeploymentResponse(future=fut)

    def _flush(self):
        while True:
            with self._lock:
                if self._timer is not None:
                    self._timer.cancel()
                    self._timer = None
                # At most max_batch_size per dispatch: a submit racing
                # between the caller's flush decision and this lock could
                # otherwise overfill the batch (observed: 9 items reaching a
                # max_batch_size=8 replica, which had shaped its jit program
                # for exactly 8).
                pending = self._pending[: self.max_batch_size]
                del self._pending[: self.max_batch_size]
                leftover = len(self._pending)
                if 0 < leftover < self.max_batch_size and self._timer is None:
                    self._timer = threading.Timer(self.wait_s, self._flush)
                    self._timer.daemon = True
                    self._timer.start()
            if not pending:
                return
            # Split by model_id (multiplexed batches must be homogeneous).
            by_model: Dict[str, List[Tuple[Any, Any]]] = {}
            for arg, fut, mid in pending:
                by_model.setdefault(mid, []).append((arg, fut))
            for mid, items in by_model.items():
                args = [a for a, _ in items]
                futs = [f for _, f in items]
                try:
                    results = self.router.call_batch(self.method, args, mid)
                    for f, r in zip(futs, results):
                        f.set_result(r)
                except Exception as e:  # noqa: BLE001
                    for f in futs:
                        f.set_result(e)
            if leftover < self.max_batch_size:
                return  # partial remainder waits out its timer


class Router:
    """One per (process, app, deployment)."""

    _routers: Dict[Tuple[str, str], "Router"] = {}
    _routers_lock = threading.Lock()

    @classmethod
    def get_or_create(cls, app_name: str, deployment_name: str) -> "Router":
        key = (app_name, deployment_name)
        with cls._routers_lock:
            r = cls._routers.get(key)
            if r is None:
                r = cls._routers[key] = Router(app_name, deployment_name)
            return r

    def __init__(self, app_name: str, deployment_name: str):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self._lock = threading.Lock()
        self._info: Optional[Dict] = None
        self._last_refresh = 0.0
        self._outstanding: Dict[int, int] = {}  # replica idx -> in-flight
        self._batchers: Dict[str, _Batcher] = {}
        self._reported_t = 0.0
        # Disaggregated handoff orchestration runs off-thread (two
        # sequential replica RPCs per request must not block the caller's
        # .remote()). Created lazily — colocated fleets never pay for it.
        self._handoff_pool = None
        # Stable identity for controller-side metrics: outstanding counts
        # are keyed per router and SUMMED across routers (EMA-blending
        # different routers into one stream undercounted the fleet).
        self._router_id = uuid.uuid4().hex[:12]

    # ------------------------------------------------------------ snapshot
    def _controller(self):
        import ray_tpu_torch
        from .controller import CONTROLLER_NAME, SERVE_NAMESPACE

        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)

    def _refresh(self, force: bool = False):
        import ray_tpu_torch

        now = time.monotonic()
        with self._lock:
            stale = force or self._info is None or now - self._last_refresh > _ROUTER_REFRESH_S
        if not stale:
            return
        try:
            info = ray_tpu_torch.get(
                self._controller().get_deployment_info.remote(self.app_name, self.deployment_name)
            )
        except Exception:  # noqa: BLE001 — controller/head unreachable
            # Head-failover survivability: replica handles route DIRECTLY
            # (actor channels never touch the head on the hot path), so a
            # router holding ANY snapshot keeps answering on it through
            # the outage. The refresh clock is advanced so a dying head is
            # probed once per refresh window, not per request; the next
            # successful refresh re-resolves the controller and re-enters
            # the telemetry/report loop. With no snapshot at all there is
            # nothing to serve from — surface the failure.
            with self._lock:
                if self._info is not None:
                    self._last_refresh = now
                    return
            raise
        if info is None:
            raise RuntimeError(
                f"Deployment {self.deployment_name} in app {self.app_name} not found"
            )
        with self._lock:
            self._info = info
            self._last_refresh = now
            self._outstanding = {i: self._outstanding.get(i, 0) for i in range(len(info["replicas"]))}

    def _replica_roles(self) -> List[Optional[str]]:
        """Per-replica pool role, controller-assigned role first (available
        the moment a replica is routable) with engine telemetry as the
        fallback. Called under self._lock."""
        info = self._info
        roles = list(info.get("replica_roles") or [])
        metas = info.get("replica_meta") or []
        out: List[Optional[str]] = []
        for i in range(len(info["replicas"])):
            r = roles[i] if i < len(roles) else None
            if not r and i < len(metas) and metas[i]:
                r = metas[i].get("role")
                r = r if r in ("prefill", "decode") else None
            out.append(r)
        return out

    def _pick_replica(
        self,
        model_id: str = "",
        prompt: Optional[List[int]] = None,
        exclude: Optional[int] = None,
        role: Optional[str] = None,
    ) -> Tuple[int, Any, str]:
        """Returns (index, replica handle, replica tag) — the tag is read
        under the same lock as the pick, so failover bookkeeping can't be
        torn by a concurrent refresh reordering the replica list. With
        `role`, candidates are restricted to that pool (falling back to the
        whole fleet when the pool is empty — a half-dead disaggregated
        deployment degrades to colocated serving, never to an error)."""
        self._refresh()
        with self._lock:
            replicas = self._info["replicas"]
            if not replicas:
                raise RuntimeError(f"No replicas for {self.deployment_name}")
            n = len(replicas)
            tags = self._info["replica_tags"]
            candidates = [i for i in range(n) if i != exclude] or list(range(n))
            if role is not None:
                from .fleet import split_pools

                pre, dec = split_pools(self._replica_roles())
                pool = pre if role == "prefill" else dec
                pool = [i for i in pool if i in set(candidates)]
                candidates = pool or candidates
            if model_id:
                # Rendezvous hash → cache-affine replica for multiplexed
                # models (same construction as the fleet plane's cold-prefix
                # convergence).
                from .fleet import rendezvous_rank

                idx = max(
                    candidates,
                    key=lambda i: rendezvous_rank(model_id, tags[i]),
                )
            elif len(candidates) == 1:
                idx = candidates[0]
            else:
                idx = self._pick_fleet(candidates, prompt)
            self._outstanding[idx] = self._outstanding.get(idx, 0) + 1
            return idx, replicas[idx], tags[idx]

    def _pick_fleet(self, candidates: List[int], prompt) -> int:
        """Prefix-affinity placement (`serve/fleet/routing.py`): hash the
        prompt's leading full KV blocks (the engine's own content-hash
        chain) and steer to the replica whose advertised hot-prefix digest
        matches deepest; cold prefixes converge by rendezvous, saturated or
        telemetry-less fleets degrade to power-of-two on load. Called under
        self._lock.

        Affinity engages only once SOME replica has reported engine
        telemetry — a deployment that never reports one (plain non-LLM
        classes whose methods happen to take numeric lists) keeps plain
        power-of-two load spreading. The controller captures telemetry on
        the same reconcile pass that PROMOTES a replica, so an LLM fleet
        has it from the moment `serve.run` returns; if a replica's report
        predates block_size (older engine), a default keeps cold routing
        deterministic."""
        info = self._info
        metas = info.get("replica_meta") or []
        chain: List[str] = []
        if (
            prompt is not None
            and info.get("prefix_affinity", True)
            and any(metas)
        ):
            bs = next(
                (m.get("block_size") for m in metas if m and m.get("block_size")),
                0,
            ) or _DEFAULT_ROUTING_BLOCK
            from .fleet import routing_chain

            chain = routing_chain(prompt, bs)
        if chain or any(m for m in metas):
            from .fleet import pick_replica as _fleet_pick

            tags = info["replica_tags"]
            spill = max(int(info.get("max_ongoing_requests") or 8), 1)
            idx, _reason = _fleet_pick(
                chain,
                [tags[i] for i in candidates],
                [metas[i] if i < len(metas) else None for i in candidates],
                {
                    j: self._outstanding.get(i, 0)
                    for j, i in enumerate(candidates)
                },
                spill,
            )
            return candidates[idx]
        # No telemetry at all: power of two choices on local outstanding.
        a, b = random.sample(candidates, 2)
        return (
            a
            if self._outstanding.get(a, 0) <= self._outstanding.get(b, 0)
            else b
        )

    def _done(self, idx: int):
        with self._lock:
            self._outstanding[idx] = max(self._outstanding.get(idx, 1) - 1, 0)

    def _maybe_report_metrics(self):
        now = time.monotonic()
        if now - self._reported_t < 1.0:
            return
        self._reported_t = now
        try:
            total = sum(self._outstanding.values())
            self._controller().record_request_metrics.remote(
                self.app_name, self.deployment_name, float(total),
                self._router_id,
            )
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------- disaggregated calls
    def _disagg_plan(
        self, method: str, args, kwargs, prompt: Optional[List[int]]
    ) -> Optional[Dict]:
        """(prompt, max_new_tokens, eos) when this call should ride the
        prefill->handoff->decode path: an LLM generation method, a token
        prompt, and BOTH pools present. None keeps the colocated path."""
        if prompt is None or method not in ("generate", "generate_stream",
                                            "__call__"):
            return None
        with self._lock:
            if self._info is None or not self._info.get("prefill_replicas"):
                return None  # colocated deployment: pay nothing per call
            from .fleet import split_pools

            pre, dec = split_pools(self._replica_roles())
            if not pre or not dec:
                return None
        max_new, eos = 16, None
        try:
            if method == "__call__":
                body = args[0].json() if hasattr(args[0], "json") else args[0]
                if not isinstance(body, dict):
                    return None
                max_new = int(body.get("max_new_tokens", 16))
                eos = body.get("eos_token")
            else:
                if len(args) > 1:
                    max_new = int(args[1])
                elif "max_new_tokens" in kwargs:
                    max_new = int(kwargs["max_new_tokens"])
                if len(args) > 2:
                    eos = args[2]
                else:
                    eos = kwargs.get("eos_token")
        except Exception:  # noqa: BLE001 — unparseable: keep colocated path
            return None
        # Captured on the CALLER's thread — the handoff pool thread that
        # executes the plan has no task context, so the trace id must ride
        # the plan dict for one x-request-id to cover the whole handoff.
        return {"prompt": list(prompt), "max_new": max_new, "eos": eos,
                "trace": tracing.get_trace_id()}

    def _colocated_fallback(self, plan: Dict, exclude_tag: Optional[str],
                            timeout_s=None) -> Dict:
        """Full recompute on one replica (decode pool preferred — its lanes
        are the scarce resource a dead prefill replica leaves idle): the
        degraded mode for ANY disagg failure, identical greedy output."""
        import ray_tpu_torch

        self._refresh(force=True)
        with self._lock:
            tags = self._info["replica_tags"]
            ex = tags.index(exclude_tag) if exclude_tag in tags else None
        idx, rep, _ = self._pick_replica(
            prompt=plan["prompt"], exclude=ex, role="decode"
        )
        try:
            return ray_tpu_torch.get(
                rep.handle_request.remote(
                    "generate",
                    (plan["prompt"], plan["max_new"], plan["eos"]), {},
                ),
                timeout=timeout_s,
            )
        finally:
            self._done(idx)

    def _disagg_prefill(self, plan: Dict) -> Tuple[Optional[Dict], Optional[Dict]]:
        """Run the prefill half on the prefill pool. Returns
        (prefill_result, finished_response): exactly one is non-None —
        a finished_response means the request completed (first token was
        the whole generation, or the prefill replica died and the
        colocated fallback answered)."""
        import ray_tpu_torch

        idx, rep, tag = self._pick_replica(
            prompt=plan["prompt"], role="prefill"
        )
        trace = plan.get("trace")
        flow = f"disagg/{trace}" if trace else None
        t0 = flight.now_ns()
        try:
            res = ray_tpu_torch.get(
                rep.handle_request.remote(
                    "prefill_handoff",
                    (plan["prompt"], plan["max_new"], plan["eos"]), {},
                ),
                timeout=_PREFILL_HANDOFF_TIMEOUT_S,
            )
        except Exception as e:  # noqa: BLE001
            if not (_is_replica_failure(e)
                    or isinstance(e, ray_tpu_torch.GetTimeoutError)):
                raise
            # Prefill replica died (or wedged) mid-handoff: recompute
            # elsewhere. Nothing imports a descriptor for THIS request —
            # the fallback recomputes from scratch, greedy-identical.
            # Death-kind span: exempt from the flight ring cap, so the
            # partial trace stays readable after a SIGKILL'd replica.
            flight.record(
                "disagg.prefill_abort", t0, flight.now_ns(), trace=trace,
                lane="serve/router", kind="death", flow=flow,
                attrs={"replica": tag, "error": type(e).__name__})
            return None, self._colocated_fallback(plan, tag)
        finally:
            self._done(idx)
        flight.record(
            "disagg.prefill_handoff", t0, flight.now_ns(), trace=trace,
            lane="serve/router", flow=flow, attrs={"replica": tag})
        if res.get("finished"):
            return None, {"tokens": res["tokens"],
                          "finish_reason": res["finish_reason"]}
        return res, None

    def _disagg_call(self, plan: Dict) -> Dict:
        """Unary prefill->handoff->decode orchestration (runs on the
        handoff pool thread). Greedy-deterministic at every fallback, so
        the response is token-for-token the colocated response no matter
        which replicas survive."""
        import ray_tpu_torch

        # Re-install the caller's trace id on this pool thread so the
        # replica RPCs (and their engine spans) inherit it.
        tracing.set_trace_id(plan.get("trace"))
        res, done = self._disagg_prefill(plan)
        if done is not None:
            return done
        first = res["tokens"][0]
        idx, rep, tag = self._pick_replica(role="decode")
        trace = plan.get("trace")
        t0 = flight.now_ns()
        try:
            rest = ray_tpu_torch.get(
                rep.handle_request.remote(
                    "decode_imported",
                    (plan["prompt"], first, plan["max_new"] - 1, plan["eos"],
                     res.get("descriptor")), {},
                )
            )
        except Exception as e:  # noqa: BLE001
            if not _is_replica_failure(e):
                raise
            flight.record(
                "disagg.decode_abort", t0, flight.now_ns(), trace=trace,
                lane="serve/router", kind="death",
                attrs={"replica": tag, "error": type(e).__name__})
            return self._colocated_fallback(plan, tag)
        finally:
            self._done(idx)
        flight.record(
            "disagg.decode", t0, flight.now_ns(), trace=trace,
            lane="serve/router",
            flow=f"disagg/{trace}" if trace else None,
            attrs={"replica": tag})
        return {"tokens": [first] + rest["tokens"],
                "finish_reason": rest["finish_reason"]}

    def _disagg_response(self, plan: Dict) -> DeploymentResponse:
        from concurrent.futures import ThreadPoolExecutor

        with self._lock:
            if self._handoff_pool is None:
                self._handoff_pool = ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="rtpu-handoff"
                )
        self._maybe_report_metrics()
        return DeploymentResponse(
            future=self._handoff_pool.submit(self._disagg_call, plan)
        )

    def _disagg_stream_gen(self, plan: Dict):
        """Streaming orchestration: yield the prefill replica's first token
        as soon as it lands (disaggregation's whole point: TTFT decoupled
        from decode load), then the decode replica's stream. Greedy
        determinism makes mid-stream failover exact: recompute colocated
        and skip what was already yielded — no wedged stream, no
        duplicated or diverging tokens."""
        import ray_tpu_torch

        tracing.set_trace_id(plan.get("trace"))
        res, done = self._disagg_prefill(plan)
        if done is not None:
            yield from done["tokens"]
            return
        first = res["tokens"][0]
        yield first
        emitted = 1
        idx, rep, tag = self._pick_replica(role="decode")
        try:
            gen = rep.handle_request_streaming.options(
                num_returns="streaming"
            ).remote(
                "decode_imported_stream",
                (plan["prompt"], first, plan["max_new"] - 1, plan["eos"]),
                {"descriptor": res.get("descriptor")},
            )
            for ref in gen:
                tok = ray_tpu_torch.get(ref)
                yield tok
                emitted += 1
        except Exception as e:  # noqa: BLE001
            if not _is_replica_failure(e):
                raise
            fb = self._colocated_fallback(plan, tag)
            yield from fb["tokens"][emitted:]
        finally:
            self._done(idx)

    # ---------------------------------------------------------------- calls
    def call(self, method: str, args, kwargs, model_id: str = "") -> DeploymentResponse:
        self._refresh()
        batch_cfg = self._info["batch_methods"].get(method)
        if batch_cfg is not None:
            if kwargs or len(args) != 1:
                raise ValueError(
                    f"@serve.batch method {method} takes exactly one positional arg"
                )
            batcher = self._batchers.get(method)
            if batcher is None:
                batcher = self._batchers[method] = _Batcher(
                    self, method, batch_cfg["max_batch_size"], batch_cfg["batch_wait_timeout_s"]
                )
            self._maybe_report_metrics()
            return batcher.submit(args[0], model_id)

        prompt = _routing_prompt(args, kwargs)
        if not model_id:
            plan = self._disagg_plan(method, args, kwargs, prompt)
            if plan is not None:
                return self._disagg_response(plan)
        idx, replica, failed_tag = self._pick_replica(model_id, prompt=prompt)
        try:
            ref = replica.handle_request.remote(method, args, kwargs, model_id)
        except Exception:
            self._done(idx)
            raise
        self._maybe_report_metrics()

        def retry(timeout_s):
            # The replica died between refreshes: force a state refresh and
            # re-route ONCE to a different replica instead of surfacing the
            # dead-handle error to the caller.
            import ray_tpu_torch

            self._refresh(force=True)
            with self._lock:
                t2 = self._info["replica_tags"]
                ex = t2.index(failed_tag) if failed_tag in t2 else None
            i2, r2, _ = self._pick_replica(model_id, prompt=prompt, exclude=ex)
            try:
                return ray_tpu_torch.get(
                    r2.handle_request.remote(method, args, kwargs, model_id),
                    timeout=timeout_s,
                )
            finally:
                self._done(i2)

        # Outstanding count drops when the caller consumes the result.
        return DeploymentResponse(
            ref=ref, on_done=lambda: self._done(idx), retry=retry
        )

    def call_streaming(
        self, method: str, args, kwargs, model_id: str = ""
    ) -> "DeploymentResponseGenerator":
        """Streaming call: chunks arrive as the replica's generator yields
        (reference: `handle.options(stream=True)` →
        ObjectRefGenerator-backed responses)."""
        self._refresh()
        prompt = _routing_prompt(args, kwargs)
        if not model_id:
            plan = self._disagg_plan(method, args, kwargs, prompt)
            if plan is not None:
                self._maybe_report_metrics()
                return DeploymentResponseGenerator(None, direct_gen=self._disagg_stream_gen(plan))
        idx, replica, _ = self._pick_replica(
            model_id, prompt=prompt
        )
        try:
            gen = getattr(replica, "handle_request_streaming").options(
                num_returns="streaming"
            ).remote(method, args, kwargs, model_id)
        except Exception:
            self._done(idx)
            raise
        self._maybe_report_metrics()
        return DeploymentResponseGenerator(gen, on_done=lambda: self._done(idx))

    def call_batch(self, method: str, batched_args: List, model_id: str) -> List:
        import ray_tpu_torch

        idx, replica, _ = self._pick_replica(model_id)
        try:
            return ray_tpu_torch.get(
                replica.handle_batch.remote(method, batched_args, model_id)
            )
        except Exception:
            self._refresh(force=True)
            raise
        finally:
            self._done(idx)


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._call(self._method, args, kwargs)


class DeploymentHandle:
    """Serializable reference to a deployment; composable across replicas
    (reference `serve/handle.py:827`)."""

    def __init__(
        self,
        app_name: str,
        deployment_name: str,
        multiplexed_model_id: str = "",
        stream: bool = False,
    ):
        self._app_name = app_name
        self._deployment_name = deployment_name
        self._model_id = multiplexed_model_id
        self._stream = stream

    def options(
        self,
        *,
        multiplexed_model_id: Optional[str] = None,
        stream: Optional[bool] = None,
    ) -> "DeploymentHandle":
        return DeploymentHandle(
            self._app_name,
            self._deployment_name,
            multiplexed_model_id if multiplexed_model_id is not None else self._model_id,
            self._stream if stream is None else stream,
        )

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._call("__call__", args, kwargs)

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def _call(self, method: str, args, kwargs) -> DeploymentResponse:
        # Resolve nested responses/refs before shipping (reference chains
        # DeploymentResponses through the object store).
        args = tuple(
            a.result() if isinstance(a, DeploymentResponse) else a for a in args
        )
        kwargs = {
            k: (v.result() if isinstance(v, DeploymentResponse) else v)
            for k, v in kwargs.items()
        }
        router = Router.get_or_create(self._app_name, self._deployment_name)
        if self._stream:
            return router.call_streaming(method, args, kwargs, self._model_id)
        return router.call(method, args, kwargs, self._model_id)

    def __reduce__(self):
        return (
            DeploymentHandle,
            (self._app_name, self._deployment_name, self._model_id, self._stream),
        )

    def __repr__(self):
        return f"DeploymentHandle({self._app_name}/{self._deployment_name})"
