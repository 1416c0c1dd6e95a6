"""Engine-metrics autoscaling policy (pure decision function).

The reference's first autoscaler consumed ONE signal: an EMA of router-reported
outstanding requests. That misses the two pressures that actually hurt an
LLM fleet — prompts queued INSIDE an engine waiting for KV admission, and
the TTFT tail those queues produce — and it happily killed replicas whose
prefix caches were serving most of the fleet's hits. This policy consumes
the engine metrics the replicas already export:

  * scale UP on queue pressure (`queue_depth` per replica over target) or
    TTFT-tail pressure (`ttft_p99_s` over target), whichever fires first —
    router-outstanding pressure (the legacy signal) still counts, summed
    correctly across routers;
  * scale DOWN only when the fleet is quiet AND the prefix-hit economics
    agree: the marginal replica's recent hit rate must be below
    `downscale_hit_rate` — a replica serving cache hits is cheaper to keep
    than to re-warm after the next burst.

The controller owns mechanics (delay gating via `last_scale_action_t`,
min/max clamping, applying the delta); this module owns only the verdict.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class FleetSignals:
    """One deployment's aggregated telemetry at decision time."""

    replicas: int                      # current routable replica count
    ongoing: float                     # outstanding reqs summed over routers
    queue_depth: float                 # engine admission queues, summed
    # Sequences currently DECODING across the fleet: a router can go silent
    # mid-generation (it only reports on new submissions), so in-flight
    # work must block scale-down on its own signal.
    running: float = 0.0
    ttft_p99_s: Optional[float] = None  # worst replica's TTFT tail
    # Per-replica recent prefix-hit rate (None = no telemetry / idle).
    hit_rates: List[Optional[float]] = dataclasses.field(default_factory=list)


def decide_scale(
    signals: FleetSignals,
    target_ongoing_requests: float,
    target_queue_depth: float,
    ttft_p99_target_s: Optional[float],
    downscale_hit_rate: float,
) -> int:
    """Return +1 (scale up), -1 (scale down), or 0 — pressure first, then
    economics. The caller applies its own delay/min/max gating."""
    n = max(signals.replicas, 1)
    ongoing_per = signals.ongoing / n
    queue_per = signals.queue_depth / n
    ttft_hot = (
        ttft_p99_target_s is not None
        and signals.ttft_p99_s is not None
        and signals.ttft_p99_s > ttft_p99_target_s
    )

    if (
        ongoing_per > target_ongoing_requests
        or queue_per > target_queue_depth
        or ttft_hot
    ):
        return 1

    quiet = (
        signals.queue_depth <= 0
        and signals.running <= 0
        and not ttft_hot
        and ongoing_per < 0.5 * target_ongoing_requests
    )
    if not quiet:
        return 0
    # Economics: only retire a replica whose cache is COLD. The coldest
    # replica is the drain candidate; an idle fleet with hot caches is a
    # warm pool, not waste. Missing telemetry reads as cold (0.0) — a
    # replica that reports nothing has nothing worth keeping warm.
    if signals.hit_rates:
        coldest = min(r if r is not None else 0.0 for r in signals.hit_rates)
        if coldest >= downscale_hit_rate:
            return 0
    return -1


def decide_scale_disagg(
    prefill: FleetSignals,
    decode: FleetSignals,
    target_ongoing_requests: float,
    target_queue_depth: float,
    ttft_p99_target_s: Optional[float],
    downscale_hit_rate: float,
) -> "tuple[int, int]":
    """Per-pool verdicts for a disaggregated deployment: (prefill_delta,
    decode_delta), each in {-1, 0, +1}.

    The pools scale on the signals they actually own (DistServe's core
    observation — prefill and decode saturate on different resources):

      * PREFILL pool — TTFT is made here (the pool computes prompts and
        emits first tokens), so the TTFT tail and the pool's admission
        queues drive it. Router-outstanding pressure is excluded: requests
        spend almost their whole life decoding, so the outstanding count
        says nothing about prefill capacity.
      * DECODE pool — queue depth, in-flight decode lanes, and the
        router-outstanding total (its proxy for inter-token pressure)
        drive it; the TTFT tail is excluded — a slow first token is never
        this pool's fault.

    Scale-down economics are unchanged per pool: quiet AND the pool's
    coldest cache below `downscale_hit_rate` (a prefill pool's warm system
    prompts are exactly the fleet-wide cache worth keeping)."""
    dp = decide_scale(
        dataclasses.replace(prefill, ongoing=0.0),
        target_ongoing_requests=target_ongoing_requests,
        target_queue_depth=target_queue_depth,
        ttft_p99_target_s=ttft_p99_target_s,
        downscale_hit_rate=downscale_hit_rate,
    )
    dd = decide_scale(
        dataclasses.replace(decode, ttft_p99_s=None),
        target_ongoing_requests=target_ongoing_requests,
        target_queue_depth=target_queue_depth,
        ttft_p99_target_s=None,
        downscale_hit_rate=downscale_hit_rate,
    )
    return dp, dd
