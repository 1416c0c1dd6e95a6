"""`LLMDeployment` — the continuous-batching engine as a Serve replica.

Contrast with `@serve.batch` (the router-side static batch former in
`serve/handle.py`): there the ROUTER forms a fixed batch and the replica
decodes it to completion — one long request gates every short one behind
it. Here each replica runs an `InferenceEngine` driver thread and actor
methods only enqueue/drain: the ENGINE re-forms the batch every decode
iteration, so a short request submitted mid-decode joins immediately and
exits first. Use `@serve.batch` for stateless fixed-shape scoring; use
`LLMDeployment` for autoregressive generation with mixed output lengths.

The replica runs with max_concurrency > 1: a `generate` call blocked
draining its stream must not gate another caller's `submit` — the actual
compute all happens on the engine's single driver thread regardless.

`engine_options` accepts every `EngineOptions` field; the serving-throughput
knobs (see serve/README.md "Prefix caching + chunked prefill"):
`enable_prefix_caching` (default on — repeated system prompts skip straight
to their first cold KV block), `max_step_tokens` / `prefill_chunk_tokens`
(chunked prefill: long prompts land a bounded slice per iteration instead
of stalling the decode streams).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..deployment import deployment as _deployment


class _LLMReplica:
    """User-facing methods of one engine replica (wrapped by Serve's generic
    `Replica` actor; streaming rides `handle_request_streaming`)."""

    def __init__(
        self,
        model: str = "gpt2-small",
        model_overrides: Optional[Dict[str, Any]] = None,
        engine_options: Optional[Dict[str, Any]] = None,
        params=None,
        device=None,  # not in the reference (deployment.py:43): None = cuda
    ):
        from ...models.gpt import CONFIGS
        from .engine import EngineOptions, InferenceEngine

        overrides = dict(model_overrides or {})
        if isinstance(overrides.get("dtype"), str):
            # Deployment specs travel the control plane as plain data;
            # accept "float32"/"bfloat16" and resolve to the torch dtype
            # here (the reference, deployment.py:49, to the jnp dtype).
            from ...device import resolve_dtype

            overrides["dtype"] = resolve_dtype(overrides["dtype"])
        cfg = CONFIGS[model](**overrides)
        self.engine = InferenceEngine(
            cfg,
            params=params,
            options=EngineOptions(**(engine_options or {})),
            device=device,  # the reference's engine has no device argument
        )
        self.engine.start()

    def generate(
        self,
        prompt: List[int],
        max_new_tokens: int = 16,
        eos_token: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Blocking: returns {"tokens": [...], "finish_reason": ...}."""
        rid = self.engine.submit(prompt, max_new_tokens, eos_token=eos_token)
        out = self.engine.stream(rid)
        tokens = list(out)
        return {"tokens": tokens, "finish_reason": out.finish_reason}

    def generate_stream(
        self,
        prompt: List[int],
        max_new_tokens: int = 16,
        eos_token: Optional[int] = None,
    ):
        """Generator: one token per chunk as iterations complete — call via
        `handle.options(stream=True).generate_stream.remote(...)`."""
        rid = self.engine.submit(prompt, max_new_tokens, eos_token=eos_token)
        yield from self.engine.stream(rid)

    def __call__(self, request) -> Dict[str, Any]:
        """HTTP ingress: POST {"prompt": [ids], "max_new_tokens": n}."""
        body = request.json() if hasattr(request, "json") else dict(request)
        return self.generate(
            body["prompt"],
            int(body.get("max_new_tokens", 16)),
            body.get("eos_token"),
        )

    # ---------------------------------------------- disaggregated serving
    # Router-orchestrated handoff (serve/handle.py `_disagg_call`): the
    # router sends the prompt to a PREFILL-pool replica's prefill_handoff,
    # which computes the prompt, emits the first token, and publishes the
    # KV as a bulk-plane span descriptor; a DECODE-pool replica then runs
    # decode_imported(_stream), which adopts the descriptor's blocks into
    # its prefix cache and resubmits prompt+[first] — admission hits the
    # imported blocks, so only the tail past the last full block is
    # recomputed. Any failure at any point degrades to plain colocated
    # recompute (greedy output is identical either way — the parity gate).

    def prefill_handoff(
        self,
        prompt: List[int],
        max_new_tokens: int = 16,
        eos_token: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Run the prefill here, return the first token + the exported KV
        descriptor for a decode-pool replica to import."""
        rid = self.engine.submit(prompt, 1, eos_token=eos_token)
        out = self.engine.stream(rid)
        tokens = list(out)
        finished = (
            max_new_tokens <= 1
            or not tokens
            or (eos_token is not None and tokens[-1] == eos_token)
        )
        desc = None
        if not finished:
            desc = self.engine.export_prompt_kv(prompt)
        return {
            "tokens": tokens,
            "finish_reason": "eos"
            if (eos_token is not None and tokens and tokens[-1] == eos_token)
            else out.finish_reason,
            "finished": finished,
            "descriptor": desc,
        }

    def decode_imported(
        self,
        prompt: List[int],
        first_token: int,
        max_new_tokens: int,
        eos_token: Optional[int] = None,
        descriptor: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Import the prefill replica's KV spans (best effort — failure
        means recompute) and continue the generation after `first_token`."""
        self.engine.import_blocks(descriptor)
        rid = self.engine.submit(
            list(prompt) + [int(first_token)], max_new_tokens,
            eos_token=eos_token,
        )
        out = self.engine.stream(rid)
        tokens = list(out)
        return {"tokens": tokens, "finish_reason": out.finish_reason}

    def decode_imported_stream(
        self,
        prompt: List[int],
        first_token: int,
        max_new_tokens: int,
        eos_token: Optional[int] = None,
        descriptor: Optional[Dict[str, Any]] = None,
    ):
        """Streaming variant of decode_imported (one token per chunk)."""
        self.engine.import_blocks(descriptor)
        rid = self.engine.submit(
            list(prompt) + [int(first_token)], max_new_tokens,
            eos_token=eos_token,
        )
        yield from self.engine.stream(rid)

    def engine_stats(self, include_raw: bool = False) -> Dict[str, Any]:
        return self.engine.stats(include_raw=include_raw)

    def fleet_state(self) -> Dict[str, Any]:
        """Telemetry the generic Replica piggybacks on controller health
        probes (`replica.telemetry`): queue depth, free blocks, hot-prefix
        digest, TTFT tail, recent prefix-hit rate, spec acceptance — the
        inputs to fleet routing and engine-metrics autoscaling."""
        return self.engine.fleet_state()


LLMDeployment = _deployment(
    name="LLMDeployment",
    max_ongoing_requests=64,
    ray_actor_options={"max_concurrency": 16},
)(_LLMReplica)
