"""ServeController actor (reference: `serve/_private/controller.py:89`,
deployment reconciler `serve/_private/deployment_state.py:1210,2307`,
autoscaling `serve/_private/autoscaling_policy.py`).

Owns the desired state (applications → deployments → target replica counts),
reconciles it against live replica actors, and serves routing info to
routers/proxies. The reference's LongPollHost broadcast becomes versioned
snapshots that routers re-fetch when stale (short-poll at the router's
refresh interval — no blocking calls into the single-threaded controller).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"
SERVE_NAMESPACE = "serve"

# A router that stops reporting for this long no longer counts toward the
# deployment's outstanding-request total (process exited, handle dropped).
_ROUTER_REPORT_TTL_S = 5.0


class _DeploymentState:
    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec
        self.target_replicas: int = spec["opts"]["num_replicas"]
        # Disaggregated pools (opts.prefill_replicas > 0): how many of the
        # target replicas run role="prefill"; the rest run role="decode".
        # Autoscaled separately from the decode pool (_maybe_autoscale).
        self.target_prefill: int = min(
            int(spec["opts"].get("prefill_replicas") or 0),
            max(self.target_replicas - 1, 0),
        )
        self.replica_roles: Dict[str, str] = {}  # tag -> prefill|decode
        self.replicas: List = []  # READY ActorHandles (routable)
        self.replica_tags: List[str] = []
        # Replicas whose __init__ has not answered a ping yet (model load +
        # jit compile can take MINUTES for LLM replicas — the reference's
        # DeploymentState keeps a STARTING state for exactly this;
        # `deployment_state.py:1210`). Not routable, not respawn-eligible
        # until replica_startup_timeout_s.
        self.starting: List = []  # [(handle, tag, started_at)]
        self.next_replica_id = 0
        # Consecutive missed pings per READY replica tag; replaced at 3.
        self.miss_counts: Dict[str, int] = {}
        # autoscaling bookkeeping: outstanding counts are keyed PER ROUTER
        # and summed — EMA-blending different routers' reports into one
        # stream undercounted the fleet (two routers with 10 outstanding
        # each converged the EMA to ~10, not 20).
        self.router_reports: Dict[str, List[float]] = {}  # id -> [ongoing, t]
        self.ongoing_ema: float = 0.0
        self.last_scale_action_t: float = 0.0
        # Latest fleet telemetry per READY replica tag (piggybacked on the
        # reconcile health probe): {"t": mono, "engine": {...} | None}.
        self.replica_meta: Dict[str, Dict[str, Any]] = {}
        self.status: str = "UPDATING"

    def ongoing_total(self, now: float) -> float:
        """Outstanding requests summed across LIVE routers; expired
        reporters are pruned in place."""
        dead = [
            rid for rid, (_, t) in self.router_reports.items()
            if now - t > _ROUTER_REPORT_TTL_S
        ]
        for rid in dead:
            del self.router_reports[rid]
        return sum(v for v, _ in self.router_reports.values())


def _drain_pool_pick(state: _DeploymentState) -> Optional[int]:
    """Index into state.replicas of the next drain victim for a
    DISAGGREGATED deployment: drain from the pool exceeding its target
    (newest first within the pool), so a decode-pool scale-down can
    never eat the prefill pool or vice versa. None = no preference.
    Module-level like the rest of _drain's logic: draining is a pure
    function of `state` (tested that way)."""
    if state.target_prefill <= 0 or not state.replicas:
        return None
    n_prefill = sum(
        1 for t in state.replica_tags
        if state.replica_roles.get(t) == "prefill"
    )
    over = (
        "prefill" if n_prefill > state.target_prefill else "decode"
    )
    for i in range(len(state.replica_tags) - 1, -1, -1):
        if state.replica_roles.get(state.replica_tags[i]) == over:
            return i
    return None


class ServeController:
    def __init__(self):
        self._lock = threading.RLock()          # guards state reads/writes (brief)
        self._reconcile_lock = threading.Lock()  # serializes reconcile passes
        self._apps: Dict[str, Dict[str, Any]] = {}  # app -> {deployments, route_prefix, ingress}
        self._version = 0
        self._shutdown = False
        self._reconciler = threading.Thread(target=self._reconcile_loop, daemon=True)
        self._reconciler.start()

    # ------------------------------------------------------------ deploy API
    def deploy_application(
        self,
        app_name: str,
        dep_specs: List[Dict[str, Any]],
        route_prefix: str,
        ingress_name: str,
        ingress_streaming: bool = False,
    ) -> None:
        import ray_tpu_torch

        with self._lock:
            old = self._apps.get(app_name, {"deployments": {}})
            deployments = {}
            reconfigure_refs = []
            for spec in dep_specs:
                name = spec["name"]
                prev = old["deployments"].get(name)
                state = _DeploymentState(spec)
                if prev is not None and prev.spec["cls"] == spec["cls"]:
                    # In-place update: keep live replicas, adopt new targets,
                    # and push the (possibly changed) user_config to them.
                    state.replicas = prev.replicas
                    state.replica_tags = prev.replica_tags
                    state.starting = prev.starting
                    state.miss_counts = prev.miss_counts
                    state.next_replica_id = prev.next_replica_id
                    state.replica_roles = prev.replica_roles
                    if state.target_prefill != prev.target_prefill:
                        # Pool split changed. A replica's role is fixed at
                        # engine start (nothing migrates a live engine), so
                        # replicas whose role no longer fits the new split
                        # are stale — drain exactly THOSE (a correctly-roled
                        # starting replica must survive); reconcile starts
                        # correctly-roled replacements via _pick_role.
                        live = list(state.replica_tags) + [
                            t for _, t, _ in state.starting
                        ]
                        roles = state.replica_roles
                        if state.target_prefill <= 0:
                            stale = [t for t in live if roles.get(t)]
                        else:
                            stale = [t for t in live if not roles.get(t)]
                            pre = [t for t in live
                                   if roles.get(t) == "prefill"]
                            dec = [t for t in live
                                   if roles.get(t) == "decode"]
                            # Pool excess: keep the oldest up to target.
                            stale += pre[state.target_prefill:]
                            stale += dec[
                                state.target_replicas - state.target_prefill:
                            ]
                        if stale:
                            self._drain(state, len(stale), tags=set(stale))
                    new_cfg = spec["opts"].get("user_config")
                    if new_cfg is not None and new_cfg != prev.spec["opts"].get("user_config"):
                        reconfigure_refs += [
                            r.reconfigure.remote(new_cfg) for r in state.replicas
                        ]
                elif prev is not None:
                    # Code changed: old replicas are stale — drain them all.
                    self._drain(prev, len(prev.replicas) + len(prev.starting))
                deployments[name] = state
            # Kill replicas of deployments that disappeared.
            for name, prev in old["deployments"].items():
                if name not in deployments:
                    self._drain(prev, len(prev.replicas) + len(prev.starting))
            self._apps[app_name] = {
                "deployments": deployments,
                "route_prefix": route_prefix,
                "ingress": ingress_name,
                "streaming": ingress_streaming,
            }
            self._version += 1
        for ref in reconfigure_refs:
            try:
                ray_tpu_torch.get(ref, timeout=30.0)
            except Exception:  # noqa: BLE001
                pass
        self._reconcile()

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            app = self._apps.pop(app_name, None)
            if app:
                for state in app["deployments"].values():
                    self._drain(state, len(state.replicas) + len(state.starting))
                self._version += 1

    def shutdown(self) -> None:
        with self._lock:
            for app_name in list(self._apps):
                self.delete_application(app_name)
            self._shutdown = True

    # ------------------------------------------------------------- routing
    def get_deployment_info(self, app_name: str, deployment_name: str) -> Optional[Dict]:
        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return None
            state = app["deployments"].get(deployment_name)
            if state is None:
                return None
            return {
                "version": self._version,
                "replicas": list(state.replicas),
                "replica_tags": list(state.replica_tags),
                "batch_methods": state.spec.get("batch_methods", {}),
                "max_ongoing_requests": state.spec["opts"]["max_ongoing_requests"],
                "prefix_affinity": state.spec["opts"].get(
                    "prefix_affinity_routing", True
                ),
                # Aligned with `replicas`: each entry is the replica's last
                # piggybacked engine telemetry (None when absent/stale) —
                # the fleet router's affinity + load inputs.
                "replica_meta": [
                    (state.replica_meta.get(t) or {}).get("engine")
                    for t in state.replica_tags
                ],
                # Disaggregated pools: the prefill-pool target (0 =
                # colocated) and each replica's controller-assigned role —
                # the router's pool split uses engine-telemetry roles, but
                # these let it know a deployment IS disaggregated before
                # first telemetry, and back tests/introspection.
                "prefill_replicas": state.target_prefill,
                "replica_roles": [
                    state.replica_roles.get(t) for t in state.replica_tags
                ],
                "status": state.status,
            }

    def routing_snapshot(self) -> Dict[str, Dict[str, str]]:
        """route_prefix -> {app, ingress} for HTTP proxies."""
        with self._lock:
            return {
                app["route_prefix"]: {
                    "app": name,
                    "ingress": app["ingress"],
                    "streaming": app.get("streaming", False),
                }
                for name, app in self._apps.items()
                if app["route_prefix"]
            }

    def app_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """app_name -> {ingress, streaming} — name-addressed ingress lookup
        (the gRPC proxy addresses apps by NAME; the HTTP route table is
        keyed by prefix and drops prefix-less apps)."""
        with self._lock:
            return {
                name: {
                    "ingress": app["ingress"],
                    "streaming": app.get("streaming", False),
                }
                for name, app in self._apps.items()
            }

    def version(self) -> int:
        return self._version

    def status(self) -> Dict[str, Any]:
        """Reference: `serve.status()` → application/deployment statuses."""
        with self._lock:
            out = {}
            for name, app in self._apps.items():
                deps = {}
                all_running = True
                for dname, state in app["deployments"].items():
                    running = len(state.replicas)
                    deps[dname] = {
                        "status": state.status,
                        "replica_states": {"RUNNING": running},
                        "target_replicas": state.target_replicas,
                    }
                    if state.status != "HEALTHY":
                        all_running = False
                out[name] = {
                    "status": "RUNNING" if all_running else "DEPLOYING",
                    "deployments": deps,
                    "route_prefix": app["route_prefix"],
                }
            return out

    # ---------------------------------------------------------- autoscaling
    def record_request_metrics(
        self,
        app_name: str,
        deployment_name: str,
        ongoing: float,
        router_id: str = "",
    ):
        """Routers report their outstanding-request counts (reference:
        `autoscaling_metrics.py` pushes replica queue lengths). Reports are
        keyed by `router_id` and SUMMED across live routers — a router that
        stops reporting expires after `_ROUTER_REPORT_TTL_S`."""
        now = time.monotonic()
        with self._lock:
            app = self._apps.get(app_name)
            if not app:
                return
            state = app["deployments"].get(deployment_name)
            if not state:
                return
            state.router_reports[router_id] = [float(ongoing), now]
            # The EMA advances inside _maybe_autoscale (once per report —
            # updating it here too would double-decay it).
            self._maybe_autoscale(state)

    def _maybe_autoscale(self, state: _DeploymentState):
        """Scale decision from the fleet policy (`serve/fleet/autoscale`):
        router-outstanding pressure (summed across routers) OR engine
        queue-depth / TTFT-tail pressure scales up; scale-down additionally
        requires the coldest replica's prefix-hit economics to agree.
        Called on every router report AND every reconcile pass — an idle
        deployment whose routers went away still scales down."""
        cfg = state.spec["opts"].get("autoscaling_config")
        if not cfg:
            return
        from .fleet import FleetSignals, decide_scale

        now = time.monotonic()
        engines = [
            m["engine"]
            for m in state.replica_meta.values()
            if m and m.get("engine")
        ]
        # Refresh the EMA toward the current router total so pressure decays
        # once routers stop reporting (expired reporters drop out of the
        # sum) — but only while SOME signal source is live: with no live
        # router reports and no engine telemetry the controller is blind,
        # and a blind decay-to-zero would scale down under in-flight work
        # (a router only reports on new submissions).
        total = state.ongoing_total(now)
        if state.router_reports or engines:
            state.ongoing_ema = 0.8 * state.ongoing_ema + 0.2 * total

        def pool_signals(pool_engines, replicas, ongoing):
            p_ttfts = [
                e["ttft_p99_s"] for e in pool_engines
                if e.get("ttft_p99_s") is not None
            ]
            return FleetSignals(
                replicas=replicas,
                ongoing=ongoing,
                queue_depth=float(
                    sum(e.get("queue_depth") or 0 for e in pool_engines)
                ),
                running=float(
                    sum(e.get("running") or 0 for e in pool_engines)
                ),
                ttft_p99_s=max(p_ttfts) if p_ttfts else None,
                hit_rates=[e.get("prefix_hit_rate") for e in pool_engines],
            )

        if state.target_prefill > 0:
            # Disaggregated pools scale on their OWN signals: the TTFT
            # tail is made in the prefill pool, queue/in-flight pressure
            # lives in the decode pool (fleet/autoscale.py rationale).
            from .fleet import decide_scale_disagg

            pre = [e for e in engines if e.get("role") == "prefill"]
            dec = [e for e in engines if e.get("role") == "decode"]
            n_pre = sum(
                1 for t in state.replica_tags
                if state.replica_roles.get(t) == "prefill"
            )
            dp, dd = decide_scale_disagg(
                pool_signals(pre, n_pre, 0.0),
                pool_signals(
                    dec, len(state.replicas) - n_pre, state.ongoing_ema
                ),
                target_ongoing_requests=cfg["target_ongoing_requests"],
                target_queue_depth=cfg.get("target_queue_depth", 4.0),
                ttft_p99_target_s=cfg.get("ttft_p99_target_s"),
                downscale_hit_rate=cfg.get("downscale_hit_rate", 0.2),
            )
            # Both pools keep >= 1 replica and the TOTAL respects the
            # deployment's min/max band and scale delays.
            target_decode = state.target_replicas - state.target_prefill
            new_prefill = max(state.target_prefill + dp, 1)
            new_decode = max(target_decode + dd, 1)
            new_total = min(
                max(new_prefill + new_decode, cfg["min_replicas"]),
                cfg["max_replicas"],
            )
            overflow = (new_prefill + new_decode) - new_total
            if overflow > 0:
                # Band clamp gives GROWTH back first: a pool that did not
                # ask to grow is never cut below its current target just
                # because the other pool hit the ceiling.
                give = min(
                    overflow, max(new_prefill - state.target_prefill, 0)
                )
                new_prefill -= give
                new_decode = max(new_decode - (overflow - give), 1)
            elif overflow < 0:
                # min_replicas floor raise: decode absorbs it (extra decode
                # lanes are always usable; extra prefill replicas idle).
                new_decode = new_total - new_prefill
            if new_total == state.target_replicas:
                # No total change = nothing to actuate: roles are assigned
                # at replica START (_pick_role) and nothing migrates a live
                # replica between pools, so acting on a pure rebalance
                # (dp=+1/dd=-1) would drift target_prefill away from the
                # fleet's real composition forever.
                return
            delay = (
                cfg["upscale_delay_s"]
                if new_total > state.target_replicas
                else cfg["downscale_delay_s"]
            )
            if now - state.last_scale_action_t <= delay:
                return
            delta = new_total - state.target_replicas
            state.target_prefill = new_prefill
            state.target_replicas = new_total
        else:
            delta = decide_scale(
                pool_signals(engines, len(state.replicas), state.ongoing_ema),
                target_ongoing_requests=cfg["target_ongoing_requests"],
                target_queue_depth=cfg.get("target_queue_depth", 4.0),
                ttft_p99_target_s=cfg.get("ttft_p99_target_s"),
                downscale_hit_rate=cfg.get("downscale_hit_rate", 0.2),
            )
            if (
                delta > 0
                and state.target_replicas < cfg["max_replicas"]
                and now - state.last_scale_action_t > cfg["upscale_delay_s"]
            ):
                state.target_replicas += 1
            elif (
                delta < 0
                and state.target_replicas > cfg["min_replicas"]
                and now - state.last_scale_action_t > cfg["downscale_delay_s"]
            ):
                state.target_replicas -= 1
            else:
                return
        state.last_scale_action_t = now
        self._version += 1
        try:
            from ..util.metrics import serve_fleet_metrics

            name = state.spec["name"]
            m = serve_fleet_metrics()
            m["serve_autoscale_decisions_total"].inc(
                1.0,
                tags={"deployment": name,
                      "direction": "up" if delta > 0 else "down"},
            )
            m["serve_deployment_target_replicas"].set(
                float(state.target_replicas), tags={"deployment": name}
            )
        except Exception:  # noqa: BLE001 — metrics never load-bearing
            pass

    # ------------------------------------------------------------ reconcile
    def _reconcile_loop(self):
        while not self._shutdown:
            time.sleep(1.0)
            try:
                self._reconcile()
            except Exception:  # noqa: BLE001
                pass

    def _reconcile(self):
        """Health-check and converge replica counts. The state lock is held
        only for snapshot/apply; pings run in parallel outside it so a dead
        replica can't stall routing or deploy calls."""
        import ray_tpu_torch

        with self._reconcile_lock:
            with self._lock:
                work = [
                    (app_name, dname, state, list(state.replicas), list(state.replica_tags))
                    for app_name, app in self._apps.items()
                    for dname, state in app["deployments"].items()
                ]
            for app_name, dname, state, replicas, tags in work:
                with self._lock:
                    starting = list(state.starting)
                probes = list(replicas) + [h for h, _, _ in starting]
                # Health probe + fleet telemetry in one RPC: an answered
                # telemetry() IS the liveness signal, and LLM replicas ship
                # their hot-prefix digest / queue depth / TTFT tail along
                # with it (routers read it back via get_deployment_info).
                refs = [h.telemetry.remote() for h in probes]
                ready = set()
                telem: Dict[Any, Any] = {}
                if refs:
                    done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=5.0)
                    for ref in done:
                        try:
                            telem[ref] = ray_tpu_torch.get(ref)
                            ready.add(ref)
                        except Exception:  # noqa: BLE001
                            pass
                ready_refs = refs[: len(replicas)]
                starting_refs = refs[len(replicas):]
                now = time.time()
                mono = time.monotonic()
                startup_tmo = float(
                    state.spec["opts"].get("replica_startup_timeout_s") or 600.0
                )

                keep, promote, kill = [], [], []
                meta_updates: Dict[str, Dict[str, Any]] = {}
                # READY replicas: a missed ping is counted, not fatal — a
                # replica busy with a long batch stays ROUTED until three
                # consecutive misses prove it wedged/dead (previously one
                # missed window silently LEAKED the actor and respawned).
                for h, t, r in zip(replicas, tags, ready_refs):
                    if r in ready:
                        state.miss_counts.pop(t, None)
                        keep.append((h, t))
                        v = telem.get(r)
                        if isinstance(v, dict) and v.get("engine") is not None:
                            meta_updates[t] = {"t": mono, "engine": v["engine"]}
                    else:
                        m = state.miss_counts.get(t, 0) + 1
                        state.miss_counts[t] = m
                        (kill if m >= 3 else keep).append((h, t))
                # STARTING replicas: a ping answer means __init__ finished →
                # promote to routable; silence is normal (model load/compile)
                # until the startup timeout.
                still_starting = []
                for (h, t, t0), r in zip(starting, starting_refs):
                    if r in ready:
                        promote.append((h, t))
                        # Telemetry lands WITH the promoting probe, so a
                        # just-promoted LLM replica is affinity-routable the
                        # moment serve.run's health wait returns.
                        v = telem.get(r)
                        if isinstance(v, dict) and v.get("engine") is not None:
                            meta_updates[t] = {"t": mono, "engine": v["engine"]}
                    elif now - t0 > startup_tmo:
                        kill.append((h, t))
                    else:
                        still_starting.append((h, t, t0))

                with self._lock:
                    # Staleness check BEFORE any kill/apply: an in-place
                    # redeploy SHARES the replica lists by reference, so a
                    # kill issued against a stale snapshot would leave a
                    # dead handle routable in the successor state.
                    app = self._apps.get(app_name)
                    if app is None or app["deployments"].get(dname) is not state:
                        continue  # redeployed/removed while we were pinging
                    routable = keep + promote
                    changed = (
                        [h for h, _ in routable] != state.replicas
                        or bool(kill)
                    )
                    state.replicas = [h for h, _ in routable]
                    state.replica_tags = [t for _, t in routable]
                    state.starting = still_starting
                    need = state.target_replicas - len(state.replicas) - len(
                        state.starting
                    )
                    excess = -need
                for h, t in kill:
                    state.miss_counts.pop(t, None)
                    state.replica_roles.pop(t, None)
                    try:
                        ray_tpu_torch.kill(h)  # never leak a replaced replica
                    except Exception:  # noqa: BLE001
                        pass
                for _ in range(max(need, 0)):
                    self._start_replica(app_name, dname, state)
                    changed = True
                if excess > 0:
                    with self._lock:
                        self._drain(state, excess)
                    changed = True
                with self._lock:
                    # Telemetry bookkeeping: adopt this pass's readings and
                    # drop tags that are no longer routable (a drained
                    # replica's digest must not keep attracting traffic).
                    live_tags = set(state.replica_tags)
                    for t, m in meta_updates.items():
                        if t in live_tags:
                            state.replica_meta[t] = m
                    for t in list(state.replica_meta):
                        if t not in live_tags:
                            del state.replica_meta[t]
                    state.status = (
                        "HEALTHY"
                        if len(state.replicas) == state.target_replicas
                        else "UPDATING"
                    )
                    if changed:
                        self._version += 1
                    # Engine-metrics autoscale tick: pressure measured AT
                    # the engines must move targets even when no router is
                    # reporting (idle fleets still need scale-down).
                    try:
                        self._maybe_autoscale(state)
                    except Exception:  # noqa: BLE001
                        pass

    def _pick_role(self, state: _DeploymentState) -> Optional[str]:
        """Role for the next replica of a disaggregated deployment: fill
        the prefill pool to its target first, decode takes the rest. None
        for colocated deployments (no role injected). Called under the
        state lock."""
        if state.target_prefill <= 0:
            return None
        live = set(state.replica_tags) | {t for _, t, _ in state.starting}
        n_prefill = sum(
            1 for t in live if state.replica_roles.get(t) == "prefill"
        )
        return "prefill" if n_prefill < state.target_prefill else "decode"

    def _start_replica(self, app_name: str, dname: str, state: _DeploymentState):
        import ray_tpu_torch
        from .replica import Replica

        spec = state.spec
        with self._lock:
            tag = f"{app_name}#{dname}#{state.next_replica_id}"
            state.next_replica_id += 1
            role = self._pick_role(state)
            if role is not None:
                state.replica_roles[tag] = role
        actor_opts = dict(spec["opts"].get("ray_actor_options") or {})
        RemoteReplica = ray_tpu_torch.remote(Replica)
        if actor_opts:
            RemoteReplica = RemoteReplica.options(**actor_opts)
        handle = RemoteReplica.remote(
            app_name,
            dname,
            tag,
            spec["cls"],
            spec["init_args"],
            spec["opts"].get("user_config"),
            role,
        )
        with self._lock:
            app = self._apps.get(app_name)
            live = app is not None and app["deployments"].get(dname) is state
            if live:
                # New replicas are STARTING (unroutable) until their first
                # answered ping proves __init__ completed.
                state.starting.append((handle, tag, time.time()))
        if not live:
            # The deployment was replaced/deleted while the actor spawned —
            # appending to the orphaned state would leak a live replica.
            import ray_tpu_torch

            state.replica_roles.pop(tag, None)
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass

    def _drain(self, state: _DeploymentState, n: int,
               tags: Optional[set] = None):
        """Kill up to `n` replicas. `tags` narrows the victims to exactly
        that set (pool-split redeploys drain the role-STALE replicas, not
        whatever drains first); None keeps the default order — unready
        (starting) replicas first, then _drain_pool_pick."""
        import ray_tpu_torch

        for _ in range(n):
            handle = tag = None
            # Unready (starting) replicas go first: they serve nothing yet.
            if state.starting:
                if tags is None:
                    handle, tag, _t0 = state.starting.pop()
                else:
                    for j in range(len(state.starting) - 1, -1, -1):
                        if state.starting[j][1] in tags:
                            handle, tag, _t0 = state.starting.pop(j)
                            break
            if handle is None and state.replicas:
                if tags is not None:
                    i = next(
                        (i for i in range(len(state.replica_tags) - 1, -1, -1)
                         if state.replica_tags[i] in tags),
                        None,
                    )
                else:
                    i = _drain_pool_pick(state)
                if i is None:
                    if tags is not None:
                        break  # no tagged victim left
                    handle = state.replicas.pop()
                    tag = state.replica_tags.pop()
                else:
                    handle = state.replicas.pop(i)
                    tag = state.replica_tags.pop(i)
            if handle is None:
                break
            # Drop the drained replica's miss counter: leaving it would leak
            # an entry per replica generation (redeploy/scale-down/delete)
            # and poison a later replica that reuses the tag. Its telemetry
            # goes too — a dead replica's digest must not attract traffic.
            state.miss_counts.pop(tag, None)
            state.replica_meta.pop(tag, None)
            state.replica_roles.pop(tag, None)
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass
            # A dead replica's metric series (engine gauges/histograms tagged
            # with its replica id) must leave /metrics now, not linger until
            # the controller's staleness sweep.
            try:
                from ..util.metrics import prune_series

                prune_series({"replica": tag})
            except Exception:  # noqa: BLE001
                pass

    def ping(self) -> str:
        return "ok"
