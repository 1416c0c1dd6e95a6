"""Fleet serving plane — the L3/L5 layer over the single-replica engine
(reference analog: Ray Serve's router/autoscaler split, PAPER.md §1).

Three cooperating planes turn a set of `LLMDeployment` replicas into a
*fleet*:

  * `routing` — prefix-affinity request placement: the router derives a
    routing key chain from the prompt's leading full KV blocks (the SAME
    chained blake2b content hash `engine/kv_manager.py` registers blocks
    under), and steers the request to the replica whose advertised hot-
    prefix digest matches deepest.  Cold prefixes converge via rendezvous
    hashing; load skew falls back to power-of-two choices, and a replica
    past its spill threshold is never picked on affinity alone.
  * `autoscale` — engine-metrics scaling decisions: scale-up triggers on
    queue-depth / TTFT-tail pressure measured AT the engines, scale-down
    only when prefix-hit economics say a replica's cache is cold.
  * speculative decoding lives in the engine (`engine/spec.py` proposer +
    `models/gpt.py:verify_step_paged`) — the fleet bench measures its
    acceptance rate per replica.

Everything here is pure policy over plain data (no JAX, no actor calls):
the Router (`serve/handle.py`) and ServeController (`serve/controller.py`)
own the mechanics.
"""

from .autoscale import FleetSignals, decide_scale, decide_scale_disagg
from .routing import (
    DIGEST_HASH_BYTES,
    pick_replica,
    rendezvous_rank,
    routing_chain,
    split_pools,
)

__all__ = [
    "DIGEST_HASH_BYTES",
    "FleetSignals",
    "decide_scale",
    "decide_scale_disagg",
    "pick_replica",
    "rendezvous_rank",
    "routing_chain",
    "split_pools",
]
