"""1F1B pipeline schedules (host-side, per stage): classic and interleaved.

The MPMD pipeline runs the classic one-forward-one-backward order
(PipeDream-flush / Megatron "1F1B"): stage s of S warms up with
min(M, S-1-s) forwards, then alternates F/B in steady state, then drains
the remaining backwards. Peak in-flight microbatches at stage s is
S - s (vs M for GPipe), which is what bounds the saved-activation memory —
the runner stores only each in-flight microbatch's stage INPUT and
recomputes the forward inside backward (`models/gpt.make_mpmd_stage_fns`).

**Interleaved (virtual-stage) 1F1B** (Megatron interleaving, arXiv
2410.06511 shape): each physical stage holds v model CHUNKS instead of one
contiguous slice — chunk c of stage s is virtual stage vs = c*S + s of
P = S*v, so the model wraps around the physical ring v times. Warmup grows
to min(M*v, (v-1)*S + 2*(S-1-s)) forwards taken in virtual-stage-major
order (S consecutive microbatches through chunk 0, the same S through
chunk 1, ...), then steady state alternates F/B with the same rotation on
both directions, then the backward drain. The bubble shrinks because the
warmup/drain ramps are per-CHUNK (depth 1/v of the model each) while the
steady region covers v*M ops: the ideal fraction drops from
(S-1)/(M+S-1) to (S-1)/(v*M + S-1). The price is a longer in-flight
window: peak saved stage-inputs at stage s become min(M*v, warmup+1)
(each saved input is 1/v of the v=1 activation depth, so memory stays
comparable; exact bound asserted across an (S, M, v) grid in
tests/test_train_mpmd.py).

The schedule is a plain per-stage op list computed up front: deterministic,
no cross-host coordination beyond the activation/grad channels themselves.
With depth-1 channels (the compiled-DAG seqlock edges) the interleaving is
deadlock-free: a virtual stage's k-th write is acked by its consumer's k-th
read, and the op order makes every recv depend only on ops EARLIER in the
producing neighbor's own list — for v>1 this needs M % S == 0 (each
warmup group feeds the next chunk exactly when its S-microbatch wave
arrives; a partial wave would leave a chunk-(c+1) recv waiting on a
chunk-c forward scheduled after it). The property test simulates every
stage's list against blocking depth-1 channels across the grid.
"""

from __future__ import annotations

from typing import List, Tuple

# Op kinds: ("F", mb, chunk) = forward microbatch mb through model chunk
# `chunk` (recv activation / take input slice, compute, send to the next
# virtual stage); ("B", mb, chunk) = backward (recv grad / compute loss
# grad, compute, send upstream, accumulate). `build_1f1b` keeps the
# classic 2-tuple form for v=1 callers.
F = "F"
B = "B"


def build_1f1b(stage: int, num_stages: int, num_microbatches: int) -> List[Tuple[str, int]]:
    """The classic (v=1) op sequence stage `stage` executes for one step."""
    S, M, s = num_stages, num_microbatches, stage
    if not 0 <= s < S:
        raise ValueError(f"stage {s} out of range for {S} stages")
    if M < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M}")
    warmup = min(M, S - 1 - s)
    ops: List[Tuple[str, int]] = [(F, i) for i in range(warmup)]
    f, b = warmup, 0
    while f < M or b < M:
        if f < M:
            ops.append((F, f))
            f += 1
        if b < M:
            ops.append((B, b))
            b += 1
    return ops


def build_interleaved_1f1b(
    stage: int, num_stages: int, num_microbatches: int, num_chunks: int = 1
) -> List[Tuple[str, int, int]]:
    """The op sequence stage `stage` executes with v model chunks per
    stage (ops are (F|B, microbatch, chunk)). v=1 reproduces `build_1f1b`
    exactly (with chunk 0 appended); v>1 is the Megatron interleaved
    order and requires num_microbatches % num_stages == 0 (see module
    docstring) and num_stages > 1 (a single stage has nothing to
    interleave across — its "wrap" edges would be self-loops)."""
    S, M, v, s = num_stages, num_microbatches, num_chunks, stage
    if v < 1:
        raise ValueError(f"num_chunks must be >= 1, got {v}")
    if v == 1:
        return [(op, mb, 0) for op, mb in build_1f1b(s, S, M)]
    if S == 1:
        raise ValueError(
            "interleaved schedule needs num_stages > 1 when num_chunks > 1 "
            "(chunk-to-chunk edges on one stage would be self-loops)"
        )
    if not 0 <= s < S:
        raise ValueError(f"stage {s} out of range for {S} stages")
    if M < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M}")
    if M % S != 0:
        raise ValueError(
            f"interleaved 1F1B needs num_microbatches % num_stages == 0 "
            f"(got M={M}, S={S}): warmup feeds chunks in waves of S "
            "microbatches and a partial wave deadlocks depth-1 channels"
        )
    total = M * v
    warmup = min(total, (v - 1) * S + 2 * (S - 1 - s))

    # k-th forward/backward in virtual-stage-major rotation: groups of
    # S*v ops; within a group, S consecutive microbatches through each
    # chunk in turn (forward ascends chunks, backward descends).
    def fwd_k(k: int) -> Tuple[int, int]:
        g, r = divmod(k, S * v)
        return g * S + r % S, r // S

    def bwd_k(k: int) -> Tuple[int, int]:
        g, r = divmod(k, S * v)
        return g * S + r % S, v - 1 - r // S

    ops: List[Tuple[str, int, int]] = [(F, *fwd_k(k)) for k in range(warmup)]
    f, b = warmup, 0
    while f < total or b < total:
        if f < total:
            ops.append((F, *fwd_k(f)))
            f += 1
        if b < total:
            ops.append((B, *bwd_k(b)))
            b += 1
    return ops


def max_in_flight(
    stage: int, num_stages: int, num_microbatches: int, num_chunks: int = 1
) -> int:
    """Peak number of (microbatch, chunk) stage inputs saved at once — the
    1F1B memory bound. v=1: min(M, S - stage). v>1: warmup+1 capped at
    M*v (the +1 is the steady state's one extra forward in flight before
    each backward retires one); each saved input spans 1/v of the v=1
    chunk depth, so the BYTES bound stays the same order."""
    S, M, v, s = num_stages, num_microbatches, num_chunks, stage
    if v == 1:
        return min(M, S - s)
    warmup = min(M * v, (v - 1) * S + 2 * (S - 1 - s))
    return min(M * v, warmup + 1)


def theoretical_bubble_fraction(
    num_stages: int, num_microbatches: int, num_chunks: int = 1
) -> float:
    """Ideal pipeline bubble for equal-cost stages:
    (S-1) / (v*M + S - 1) — interleaving divides the warmup/drain ramp
    depth by v while the steady region keeps v*M ops per stage."""
    S, M, v = num_stages, num_microbatches, num_chunks
    return (S - 1) / (v * M + S - 1)
