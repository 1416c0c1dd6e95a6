"""In-process MPMD pipeline: the REAL 1F1B interleaving on threads (port of
`ray_tpu/train/mpmd/local.py`).

One thread per (stage, dp-replica), queue edges, in-process dp collectives.
This is the parity harness (losses/grads vs the unpipelined program and the
in-mesh GPipe pipeline, no cluster boot) and the deadlock gate for the
schedule — the cluster trainer (`trainer.py`) swaps in gang actors,
compiled-DAG channels, and the object-store collectives around the SAME
StageRunner. Interleaving (num_chunks = v > 1) wires per-chunk edges plus
the wrap edges chunk c of stage S-1 -> chunk c+1 of stage 0; tied
embeddings add the first/last-stage bridge pair (always f32 — gradients for
the update never ride the lossy wire). `wire_dtype="bf16"` runs every
activation/grad hop through the real WireCodec.

The runners' device is `device=` (the card unless the caller asks for the
CPU); every thread of one call uses it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...device import resolve_device
from .stage import StageRunner
from .transport import LocalEdge, WireCodec
from .zero import make_local_comms


def run_local_pipeline(
    cfg,
    num_stages: int,
    dp: int,
    num_microbatches: int,
    batches: List[np.ndarray],
    *,
    params=None,
    seed: int = 0,
    num_chunks: int = 1,
    wire_dtype: str = "f32",
    zero: bool = True,
    lr: float = 1e-3,
    betas=(0.9, 0.95),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    step_timeout_s: float = 120.0,
    on_step: Optional[Callable[[int], None]] = None,
    device=None,
) -> Dict[str, Any]:
    """Train over `batches` (each [B, S+1] int tokens, an array or tensor;
    B divisible by dp * num_microbatches) and return {"history": per-step
    driver metrics, "params": final full param tree (CPU tensors),
    "runners": the stage runners, "wall_s"/"bubble_frac": run aggregates,
    "wire_stats": codec byte counters summed over every activation/grad
    edge}. `params` is a dict of tensors (or arrays) in the model's stacked
    layout; None seeds `gpt.init_params(cfg, seed)` on the CPU.
    """
    from ...models import gpt

    device = resolve_device(device)
    S, v = num_stages, num_chunks
    gpt.check_mpmd_partitionable(cfg, S, v)
    if params is None:
        params = gpt.init_params(cfg, seed=seed, device="cpu")
    params = {k: torch.as_tensor(x) for k, x in params.items()}

    runners: List[List[StageRunner]] = []
    for s in range(S):
        comms = make_local_comms(dp)
        chunk_trees = [gpt.extract_stage_params(params, cfg, s, S, num_chunks=v, chunk=c) for c in range(v)]
        runners.append([
            StageRunner(
                cfg, s, S, num_microbatches,
                chunk_trees if v > 1 else chunk_trees[0],
                comms[r], replica=r, num_chunks=v, zero=zero, lr=lr,
                betas=betas, eps=eps, weight_decay=weight_decay, device=device,
            )
            for r in range(dp)
        ])

    # The activation/grad wire: one codec (and its byte counters) shared by
    # every edge; bridges get their own f32 identity codec.
    codec = WireCodec(wire_dtype)
    bridge = cfg.tie_embeddings and S > 1
    for r in range(dp):
        fwd_in = [[None] * v for _ in range(S)]
        fwd_out = [[None] * v for _ in range(S)]
        bwd_in = [[None] * v for _ in range(S)]
        bwd_out = [[None] * v for _ in range(S)]

        def edge():
            return LocalEdge(timeout_s=step_timeout_s, codec=codec)

        for c in range(v):
            for s in range(S - 1):
                e, eb = edge(), edge()
                fwd_out[s][c] = e
                fwd_in[s + 1][c] = e
                bwd_out[s + 1][c] = eb
                bwd_in[s][c] = eb
        # Wrap edges: virtual stage c*S + (S-1) feeds (c+1)*S + 0.
        for c in range(v - 1):
            e, eb = edge(), edge()
            fwd_out[S - 1][c] = e
            fwd_in[0][c + 1] = e
            bwd_out[0][c + 1] = eb
            bwd_in[S - 1][c] = eb
        bridges = {}
        if bridge:
            b_fwd = LocalEdge(timeout_s=step_timeout_s)
            b_bwd = LocalEdge(timeout_s=step_timeout_s)
            bridges[0] = {"bridge_out": b_fwd, "bridge_in": b_bwd}
            bridges[S - 1] = {"bridge_out": b_bwd, "bridge_in": b_fwd}
        for s in range(S):
            runners[s][r].bind_edges(
                fwd_in=fwd_in[s], fwd_out=fwd_out[s],
                bwd_in=bwd_in[s], bwd_out=bwd_out[s],
                **bridges.get(s, {}),
            )

    results: Dict[tuple, List[Dict[str, Any]]] = {}
    errors: List[BaseException] = []

    def worker(s: int, r: int):
        try:
            out = []
            for step, batch in enumerate(batches):
                sl = None
                if s == 0 or s == S - 1:
                    sl = torch.tensor_split(torch.as_tensor(batch), dp)[r]
                out.append(runners[s][r].run_step(sl))
                if on_step is not None and s == 0 and r == 0:
                    on_step(step)
            results[(s, r)] = out
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s, r), daemon=True) for s in range(S) for r in range(dp)]
    import time as _time

    run_t0 = _time.monotonic()
    for t in threads:
        t.start()
    deadline = step_timeout_s * max(1, len(batches))
    for t in threads:
        t.join(timeout=deadline)
        if t.is_alive():
            raise RuntimeError(
                "local MPMD pipeline wedged (schedule deadlock or a dead "
                f"sibling thread); errors so far: {errors!r}"
            )
    run_wall = _time.monotonic() - run_t0
    if errors:
        raise errors[0]

    history: List[Dict[str, Any]] = []
    for step in range(len(batches)):
        last = [results[(S - 1, r)][step] for r in range(dp)]
        per_stage = [results[(s, 0)][step] for s in range(S)]
        history.append({
            "step": step + 1,
            "loss": float(np.mean([m["loss"] for m in last])),
            "grad_norm": float(np.sqrt(sum(m["grad_sumsq"] for m in per_stage))),
            "busy_s": sum(results[(s, r)][step]["busy_s"] for s in range(S) for r in range(dp)),
            "opt_bytes_per_replica": max(m["opt_bytes"] for m in per_stage),
        })

    # Reassemble the full model tree from replica-0 runners in VIRTUAL
    # STAGE order — layer slices concatenate chunk-major (vs = c*S + s),
    # which is exactly how extract_stage_params dealt them out. Replicas
    # are identical post-update by the all-gather contract; with tied
    # embeddings, tok_embed appears on both boundary virtual stages
    # (bit-identical post-bridge) and setdefault keeps the first.
    merged: Dict[str, torch.Tensor] = {}
    layer_parts: Dict[str, List[torch.Tensor]] = {}
    for c in range(v):
        for s in range(S):
            tree = runners[s][0].chunk_params_host(c)
            for k, val in tree.items():
                if k in gpt_layer_keys():
                    layer_parts.setdefault(k, []).append(val)
                else:
                    merged.setdefault(k, val)
    for k, parts in layer_parts.items():
        merged[k] = torch.cat(parts, dim=0)
    # Aggregate pipeline-bubble number for the whole run, trainer-style
    # denominator (wall * PHYSICAL lanes S*dp: a stage's chunks share one
    # host thread) with the optimizer update in the numerator — the same
    # busy definition as the flight recorder's span-derived attribution.
    busy_total = sum(m["busy_s"] + m.get("update_s", 0.0) for outs in results.values() for m in outs)
    lanes = S * dp
    bubble = max(0.0, 1.0 - busy_total / max(run_wall * lanes, 1e-9))
    return {"history": history, "params": merged, "runners": runners,
            "wall_s": run_wall, "bubble_frac": bubble,
            "wire_stats": dict(codec.stats)}


def gpt_layer_keys():
    from ...models.gpt import _LAYER_KEYS

    return _LAYER_KEYS
