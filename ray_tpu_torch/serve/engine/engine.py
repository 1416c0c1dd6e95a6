"""Continuous-batching inference engine on PyTorch — the port of
`ray_tpu/serve/engine/engine.py` (vLLM-style `step()` loop: iteration-level
scheduling over a paged KV cache, driving `models/gpt.py`'s paged path).

One `step()` is one model iteration:

    1. `Scheduler.schedule()` re-forms the working set — admits queued
       prompts the moment the KV budget (free + reclaimable cached blocks)
       covers them (prefix-cache lookup first), preempts on exhaustion.
    2. Prefill advances in CHUNKS under a per-step token budget; the final
       chunk emits the first token (TTFT).
    3. All fully-prefilled sequences advance one token through ONE
       `decode_step_paged` call (or `verify_step_paged` when speculative
       drafts are funded), the batch padded to a power-of-two lane bucket
       and block-table width bucket with null block 0 — the reference's
       shape discipline, kept so both engines run the same batches.
    4. New tokens stream to per-request output queues; finished sequences
       retire and return their blocks for the next step.

The KV pool is updated IN PLACE by the paged functions (the reference
donates it to each jitted call instead). All device work runs on the
thread that calls `step()` — the driver thread after `start()`;
`submit()`/`stream()` may be called from any thread — replica actor method
threads under Serve (`LLMDeployment` runs with max_concurrency > 1 so a
blocked `generate` never gates another request's `submit`).

Under Serve the engine tags its Prometheus series with the replica context,
ships per-request tracing spans and flight-recorder step spans, and
exports and imports computed KV blocks between replicas (disaggregated
prefill/decode, `kv_transfer.py`). The pool lives on the card, so an export
copies its blocks to the host (`_block_blobs`) before they go into the
transfer frame, and an import lands them back at the next step boundary.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...models.gpt import decode_step_paged, init_paged_cache, init_params, prefill_paged, verify_step_paged
from ...util.metrics import quantile as _quantile
from .kv_manager import KVBlockManager
from .scheduler import Scheduler, Sequence, SchedulerOutput, _next_pow2

_FINISH = object()  # stream sentinel


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    num_blocks: int = 64          # physical KV blocks (incl. null block 0)
    block_size: int = 16          # token slots per block
    max_num_seqs: int = 8         # decode-batch lane ceiling
    max_prefills_per_step: int = 1
    # Chunked prefill: per-step token budget (decode lanes cost 1 each,
    # prefill chunks spend the rest) and the per-chunk length cap.
    max_step_tokens: int = 256
    prefill_chunk_tokens: int = 64
    # Automatic prefix caching: full KV blocks are content-hashed and
    # shared; freed blocks are retained (reclaimable, LRU-evicted).
    enable_prefix_caching: bool = True
    # Speculative decoding (greedy only): per-lane draft length k proposed
    # by n-gram prompt lookup (spec.py) and scored in ONE verify forward.
    # 0 disables. Draft tokens are funded inside `max_step_tokens`.
    spec_tokens: int = 0
    spec_ngram: int = 2
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0
    # "mixed" (default), "prefill" (step budget biased toward prefill
    # chunks) or "decode" (prefill's per-step share capped at
    # max_step_tokens/4).
    role: str = "mixed"
    # Host-RAM KV tier budget (bytes; 0 disables): evicted registered blocks
    # are saved here and re-admitted by a host->device copy on a hit, and
    # are exportable to other replicas over the bulk plane.
    host_kv_bytes: int = 32 << 20
    # Deadline for one KV export/import (span fetch + handoff plumbing).
    kv_transfer_timeout_s: float = 30.0


class RequestOutput:
    """Per-request stream endpoint: the engine thread feeds it, any
    consumer thread drains it."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._q: "queue.Queue" = queue.Queue()
        self.finish_reason: Optional[str] = None
        # The engine drops the registry entry once the request is BOTH
        # finished and retrieved, whichever happens first.
        self.finished = False
        self.retrieved = False

    def __iter__(self) -> Iterator[int]:
        while True:
            item = self._q.get()
            if item is _FINISH:
                return
            if isinstance(item, Exception):
                raise item
            yield item


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy; bf16 travels as its raw int16 bits (numpy
    has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _to_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(like.device)
    return t.view(torch.bfloat16) if like.dtype == torch.bfloat16 else t.to(like.dtype)


class InferenceEngine:
    def __init__(
        self,
        cfg,
        params=None,
        options: Optional[EngineOptions] = None,
        device=None,
    ):
        self.cfg = cfg
        self.opts = options or EngineOptions()
        if self.opts.role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"role must be mixed|prefill|decode, got {self.opts.role!r}"
            )
        self.device = resolve_device(device)
        if params is None:
            # Stored in cfg.dtype (serving weights); the reference
            # (engine.py:160) keeps f32 master params and casts per layer.
            params = init_params(cfg, seed=self.opts.seed, device=self.device, dtype=cfg.dtype)
        self.params = params
        self.kv = init_paged_cache(
            self.cfg, self.opts.num_blocks, self.opts.block_size, device=self.device
        )
        self.host_tier = None
        if self.opts.host_kv_bytes > 0 and self.opts.enable_prefix_caching:
            from .kv_tier import HostKVTier

            self.host_tier = HostKVTier(self.opts.host_kv_bytes)
        self.block_manager = KVBlockManager(
            self.opts.num_blocks,
            self.opts.block_size,
            enable_prefix_caching=self.opts.enable_prefix_caching,
            host_tier=self.host_tier,
        )
        proposer = None
        if self.opts.spec_tokens > 0:
            if self.opts.temperature > 0.0:
                # The greedy accept rule only reproduces GREEDY decode;
                # sampled decode would need rejection sampling.
                raise ValueError(
                    "speculative decoding requires temperature=0 (greedy)"
                )
            from .spec import NGramProposer

            proposer = NGramProposer(
                k=self.opts.spec_tokens, n=self.opts.spec_ngram
            )
        mpps = self.opts.max_prefills_per_step
        prefill_cap = None
        if self.opts.role == "prefill":
            mpps = max(mpps, 4)
        elif self.opts.role == "decode":
            prefill_cap = max(
                self.opts.prefill_chunk_tokens, self.opts.max_step_tokens // 4
            )
        self.scheduler = Scheduler(
            self.block_manager,
            max_num_seqs=self.opts.max_num_seqs,
            max_prefills_per_step=mpps,
            max_step_tokens=self.opts.max_step_tokens,
            prefill_chunk=self.opts.prefill_chunk_tokens,
            draft_proposer=proposer,
            prefill_budget_cap=prefill_cap,
        )
        # Instance attributes, so a caller can wrap the device functions
        # (chip_smoke.py checks every logits tensor is finite).
        self._prefill, self._decode, self._verify = (
            prefill_paged, decode_step_paged, verify_step_paged
        )
        self._sample_rng = np.random.default_rng(self.opts.seed)
        self._lock = threading.Lock()          # scheduler + queues
        self._work = threading.Condition(self._lock)
        self._outputs: Dict[str, RequestOutput] = {}
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.total_tokens = 0
        self.total_preemptions = 0
        self.total_finished = 0
        self.total_spec_proposed = 0
        self.total_spec_accepted = 0
        self.total_blocks_imported = 0
        self.total_blocks_exported = 0
        # Side work serviced by the driver thread at step boundaries, where
        # self.kv is stable (the paged functions write it in place, so no
        # other thread may read it while a step runs): ("export", digests,
        # Future) entries from export_prompt_kv.
        self._side_work: "deque" = deque()
        self._ttfts: "deque[float]" = deque(maxlen=1024)
        self._tpots: "deque[float]" = deque(maxlen=1024)
        self._step_ttfts: List[float] = []     # reset each step()
        self._step_tpots: List[float] = []
        self._step_spec = [0, 0]               # [proposed, accepted]
        self._tok_window: List[float] = []     # token-emit timestamps
        # (t, hits, misses) snapshots — fleet_state's recent hit-rate window.
        self._hit_snaps: "deque" = deque(maxlen=64)
        # request_id -> {trace, submit_t, admit_t, first_t} (wall-clock):
        # per-request span bookkeeping for traced (Serve) submissions —
        # untraced submits (engine unit tests, direct callers) skip it.
        self._trace_info: Dict[str, Dict[str, Any]] = {}
        self._init_metrics()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long).to(self.device)

    # ------------------------------------------------------------- metrics
    def _init_metrics(self):
        try:
            from ...util.metrics import Counter, Gauge, Histogram

            self._m_queue = Gauge(
                "serve_engine_queue_depth", "prompts waiting for KV admission"
            )
            self._m_running = Gauge(
                "serve_engine_running_seqs", "sequences in the decode batch"
            )
            self._m_kv = Gauge(
                "serve_engine_kv_utilization", "allocated fraction of KV blocks"
            )
            self._m_tps = Gauge(
                "serve_engine_tokens_per_s", "generated tokens/s (10s window)"
            )
            self._m_tokens = Counter(
                "serve_engine_tokens_total", "tokens generated"
            )
            self._m_preempt = Counter(
                "serve_engine_preemptions_total", "recompute preemptions"
            )
            self._m_ttft = Histogram(
                "serve_engine_ttft_s", "time to first token"
            )
            self._m_tpot = Histogram(
                "serve_engine_tpot_s", "time per output token after the first"
            )
            self._m_pc_hits = Counter(
                "serve_engine_prefix_cache_hits_total",
                "KV blocks served from the prefix cache",
            )
            self._m_pc_misses = Counter(
                "serve_engine_prefix_cache_misses_total",
                "cacheable KV blocks that had to be computed",
            )
            self._m_pc_evict = Counter(
                "serve_engine_prefix_cache_evictions_total",
                "cached KV blocks reclaimed for new allocations",
            )
            self._m_step_tokens = Histogram(
                "serve_engine_step_budget_tokens",
                "tokens scheduled per engine step "
                "(decode lanes + prefill chunk tokens)",
                boundaries=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
            )
            self._m_spec_prop = Counter(
                "serve_engine_spec_proposed_total",
                "speculative draft tokens scored by the verify step",
            )
            self._m_spec_acc = Counter(
                "serve_engine_spec_accepted_total",
                "speculative draft tokens accepted (emitted without a "
                "dedicated decode step)",
            )
            self._m_host_hits = Counter(
                "serve_engine_host_tier_hits_total",
                "prefix-cache hits served from the host-RAM KV tier",
            )
            self._m_host_bytes = Gauge(
                "serve_engine_host_tier_bytes",
                "bytes resident in the host-RAM KV tier",
            )
            self._m_kv_import = Counter(
                "serve_engine_kv_blocks_imported_total",
                "KV blocks imported from other replicas (disagg handoff / "
                "cluster-wide prefix cache)",
            )
            self._m_kv_export = Counter(
                "serve_engine_kv_blocks_exported_total",
                "KV blocks exported as bulk-plane span segments",
            )
            # Counters export monotonic increments; the KV manager keeps
            # lifetime totals — ship deltas since the last step.
            self._kv_exported = {"hits": 0, "misses": 0, "evictions": 0,
                                 "host_hits": 0, "imported": 0, "exported": 0}
            try:
                # Under Serve, tag every series with its replica so scrapes
                # distinguish replicas and the controller can prune a
                # drained replica's series (serve/controller._drain).
                from ..context import get_replica_context

                ctx = get_replica_context()
                tags = {"app": ctx.app_name, "deployment": ctx.deployment,
                        "replica": ctx.replica_tag,
                        "role": self.opts.role}
                for m in (self._m_queue, self._m_running, self._m_kv,
                          self._m_tps, self._m_tokens, self._m_preempt,
                          self._m_ttft, self._m_tpot, self._m_pc_hits,
                          self._m_pc_misses, self._m_pc_evict,
                          self._m_step_tokens, self._m_spec_prop,
                          self._m_spec_acc, self._m_host_hits,
                          self._m_host_bytes, self._m_kv_import,
                          self._m_kv_export):
                    m.set_default_tags(tags)
            except Exception:  # noqa: BLE001 — engine used outside Serve
                pass
        except Exception:  # noqa: BLE001 — metrics are never load-bearing
            self._m_queue = None

    def _export_metrics(self, stats: Dict[str, Any]):
        if self._m_queue is None:
            return
        try:
            self._m_queue.set(stats["queue_depth"])
            self._m_running.set(stats["running"])
            self._m_kv.set(stats["kv_utilization"])
            self._m_tps.set(stats["tokens_per_s"])
            if stats["step_tokens"]:
                self._m_tokens.inc(stats["step_tokens"])
            if stats["step_preemptions"]:
                self._m_preempt.inc(stats["step_preemptions"])
            for t in stats["step_ttfts"]:
                self._m_ttft.observe(t)
            for t in stats["step_tpots"]:
                self._m_tpot.observe(t)
            for key, stat_key, counter in (
                ("hits", "prefix_cache_hits", self._m_pc_hits),
                ("misses", "prefix_cache_misses", self._m_pc_misses),
                ("evictions", "prefix_cache_evictions", self._m_pc_evict),
                ("host_hits", "host_tier_hits", self._m_host_hits),
                ("imported", "blocks_imported", self._m_kv_import),
                ("exported", "blocks_exported", self._m_kv_export),
            ):
                delta = stats[stat_key] - self._kv_exported[key]
                if delta > 0:
                    counter.inc(delta)
                    self._kv_exported[key] += delta
            self._m_host_bytes.set(stats["host_tier_bytes"])
            if stats["step_budget_tokens"]:
                self._m_step_tokens.observe(stats["step_budget_tokens"])
            if stats["step_spec_proposed"]:
                self._m_spec_prop.inc(stats["step_spec_proposed"])
            if stats["step_spec_accepted"]:
                self._m_spec_acc.inc(stats["step_spec_accepted"])
        except Exception:  # noqa: BLE001 — no runtime in unit tests
            pass

    # -------------------------------------------------------------- intake
    def submit(
        self,
        prompt: List[int],
        max_new_tokens: int,
        request_id: Optional[str] = None,
        eos_token: Optional[int] = None,
    ) -> str:
        """Enqueue a request; returns its id immediately. Raises ValueError
        for requests that could NEVER run (too long for the model window or
        the whole KV pool) — transient fullness just queues."""
        if self._stop.is_set():
            raise RuntimeError("engine is shut down")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds max_seq {self.cfg.max_seq}"
            )
        if not self.block_manager.fits_ever(len(prompt) + max_new_tokens):
            raise ValueError(
                f"request needs {len(prompt) + max_new_tokens} KV slots; pool "
                f"holds {(self.opts.num_blocks - 1) * self.opts.block_size}"
            )
        try:
            from ...util.tracing import get_trace_id

            trace_id = get_trace_id()
        except Exception:  # noqa: BLE001
            trace_id = None
        with self._work:
            if request_id is None:
                request_id = f"req-{self._next_id}"
                self._next_id += 1
            seq = Sequence(
                request_id=request_id,
                prompt=prompt,
                max_new_tokens=max_new_tokens,
                eos_token=eos_token,
            )
            self.scheduler.add(seq)
            self._outputs[request_id] = RequestOutput(request_id)
            if trace_id:
                self._trace_info[request_id] = {
                    "trace": trace_id, "submit_t": time.time(),
                }
            self._work.notify_all()
        return request_id

    def stream(self, request_id: str) -> RequestOutput:
        """Claim a request's output stream (single consumer). Valid until
        claimed no matter how fast the request finished; unknown/already-
        claimed ids raise KeyError."""
        with self._lock:
            out = self._outputs[request_id]
            out.retrieved = True
            if out.finished:
                del self._outputs[request_id]
            return out

    def generate(
        self,
        prompt: List[int],
        max_new_tokens: int,
        eos_token: Optional[int] = None,
    ) -> List[int]:
        """Blocking convenience: submit + drain (the driver thread must be
        running — `start()` — or another thread must call `step()`)."""
        rid = self.submit(prompt, max_new_tokens, eos_token=eos_token)
        return list(self.stream(rid))

    # ---------------------------------------------------------------- step
    def _sample(self, logits_row) -> int:
        if self.opts.temperature <= 0.0:
            return int(logits_row.argmax())
        z = logits_row / self.opts.temperature
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._sample_rng.choice(len(p), p=p))

    def _emit(self, seq: Sequence, tok: int):
        seq.append_token(tok)
        out = self._outputs.get(seq.request_id)
        if out is not None:
            out._q.put(tok)
        self.total_tokens += 1
        self._tok_window.append(time.monotonic())

    def _maybe_finish(self, seq: Sequence) -> bool:
        reason = seq.should_stop()
        if reason is None:
            return False
        with self._lock:
            self.scheduler.finish(seq, reason)
            out = self._outputs.get(seq.request_id)
            if out is not None:
                out.finish_reason = reason
                out.finished = True
                if out.retrieved:
                    del self._outputs[seq.request_id]
        if out is not None:
            out._q.put(_FINISH)
        self.total_finished += 1
        if seq.first_token_t is not None:
            ttft = seq.first_token_t - seq.arrival_t
            self._ttfts.append(ttft)
            self._step_ttfts.append(ttft)
            n = seq.num_generated  # survives preemption's output fold
            if n > 1 and seq.finish_t is not None:
                tpot = (seq.finish_t - seq.first_token_t) / (n - 1)
                self._tpots.append(tpot)
                self._step_tpots.append(tpot)
        self._emit_request_spans(seq)
        return True

    def _emit_request_spans(self, seq: Sequence):
        """Ship queue-wait/admission/prefill/first-token/completion spans for
        a finished traced request (one shipment per request)."""
        rec = self._trace_info.pop(seq.request_id, None)
        if rec is None:
            return
        try:
            from ...util.tracing import record_events, span_event

            tid = rec["trace"]
            now = time.time()
            submit = rec["submit_t"]
            admit = rec.get("admit_t", now)
            first = rec.get("first_t", admit)
            attrs = {"request_id": seq.request_id,
                     "tokens": seq.num_generated}
            # One control-plane message for the whole request — per-span
            # sends inside step() would stall the decode loop for every
            # in-flight sequence at high completion rates.
            record_events([
                span_event("engine.queue_wait", submit, admit - submit,
                           trace_id=tid, attrs=attrs),
                span_event("engine.admission", admit, 0.0, trace_id=tid,
                           attrs=attrs),
                span_event("engine.prefill", admit, first - admit,
                           trace_id=tid, attrs=attrs),
                span_event("engine.first_token", first, 0.0, trace_id=tid,
                           attrs=attrs),
                span_event("engine.completion", first, now - first,
                           trace_id=tid,
                           attrs={**attrs, "finish_reason": seq.finish_reason}),
            ])
        except Exception:  # noqa: BLE001 — tracing is never load-bearing
            pass

    def _apply_cow(self):
        """Land queued copy-on-write block copies (shared block forked by
        the scheduler) on the KV pool before any kernel reads them."""
        copies = self.block_manager.drain_cow()
        if not copies:
            return
        src = self._tensor([s for s, _ in copies])
        dst = self._tensor([d for _, d in copies])
        for arr in self.kv.values():
            arr[:, dst] = arr[:, src]  # the right side is gathered first

    # ----------------------------------------------------- tiered KV cache
    #
    # Step-top drain order is a correctness contract (kv_manager header):
    # SAVES read evicted blocks' bytes before anything overwrites them,
    # then COW copies, then LOADS land tier bytes, then kernels run.

    def _block_blobs(self, blocks: List[int]):
        """The given blocks' KV bytes as contiguous host arrays [2(k/v),
        L, H, BS, Dh] each — the unit of the host tier. One device read per
        KV array, then per-block host copies."""
        idx = self._tensor(blocks)
        ks = _to_host(self.kv["k"][:, idx])   # [L, n, H, BS, Dh]
        vs = _to_host(self.kv["v"][:, idx])
        return [
            np.ascontiguousarray(np.stack([ks[:, i], vs[:, i]]))
            for i in range(len(blocks))
        ]

    def _apply_host_saves(self):
        """Copy evicted registered blocks' bytes into the host tier (FIRST
        drain: the blocks are already reallocated, and COW/loads/kernels
        may overwrite them later this step)."""
        with self._lock:
            saves = self.block_manager.drain_saves()
        if not saves or self.host_tier is None:
            return
        blobs = self._block_blobs([b for _, b in saves])
        with self._lock:
            for (h, _), blob in zip(saves, blobs):
                self.host_tier.put(h, blob)

    def _apply_host_loads(self):
        """Land tier-hit and imported block bytes on the device pool before
        any kernel reads them (after saves + COW)."""
        with self._lock:
            loads = self.block_manager.drain_loads()
        if not loads:
            return
        idx = self._tensor([b for _, b, _, _ in loads])
        ks = np.stack([np.asarray(blob[0]) for _, _, blob, _ in loads])
        vs = np.stack([np.asarray(blob[1]) for _, _, blob, _ in loads])
        self.kv["k"][:, idx] = _to_device(ks.swapaxes(0, 1), self.kv["k"])
        self.kv["v"][:, idx] = _to_device(vs.swapaxes(0, 1), self.kv["v"])
        # Local host-tier re-admissions are NOT imports (host_hits counts
        # them) — the import counter tracks only remotely-computed blocks.
        self.total_blocks_imported += sum(
            1 for _, _, _, remote in loads if remote
        )

    # -------------------------------------------------------- KV transfer
    def _kv_sig(self) -> str:
        """Layout signature guarding imports: block bytes only interchange
        between engines with identical model geometry, block size, and
        dtype."""
        c = self.cfg
        # The reference (engine.py:673) writes the jnp dtype's `.str`. The
        # pool's dtype goes by its name ("bfloat16", "float32"): bf16 blocks
        # travel as raw int16 bits (`_to_host`), which are no int16 pool.
        dtype = str(self.kv["k"].dtype).removeprefix("torch.")
        return (
            f"{c.n_layers}:{c.n_heads}:{c.d_head}:{self.opts.block_size}:"
            f"{dtype}"
        )

    def prompt_digests(self, prompt: List[int]) -> List[bytes]:
        """Chain digests of EVERY full block of `prompt` (the kv_manager's
        content address). Unlike admission's cacheable cap this includes a
        block ending exactly at the prompt tail — after a completed prefill
        `register_computed` has registered all of them."""
        from .kv_manager import _chain_hash

        bs = self.opts.block_size
        out: List[bytes] = []
        prev = b""
        for i in range(len(prompt) // bs):
            prev = _chain_hash(prev, prompt[i * bs:(i + 1) * bs])
            out.append(prev)
        return out

    def export_prompt_kv(
        self, prompt: List[int], timeout_s: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        """Publish `prompt`'s computed full-block KV as a span descriptor
        (kv_transfer.export_descriptor) any replica can import. Runs on the
        driver thread at a step boundary (the only safe point to read the
        donated KV arrays); this caller blocks until serviced. Returns None
        when there is nothing exportable (short prompt, blocks already
        evicted everywhere, engine stopped)."""
        digests = self.prompt_digests(prompt)
        if not digests or self._stop.is_set():
            return None
        from concurrent.futures import Future, TimeoutError as _FutTimeout

        from ...util import flight
        from ...util.tracing import get_trace_id

        # Captured HERE (the replica RPC thread carries the request's task
        # context); _do_export runs on the driver thread, which has none.
        # The trace rides the descriptor so the importing replica's spans
        # join the same x-request-id forest.
        trace = get_trace_id()
        t0 = flight.now_ns()
        fut: "Future" = Future()
        with self._work:
            self._side_work.append(("export", digests, fut))
            self._work.notify_all()
        try:
            desc = fut.result(
                timeout_s if timeout_s is not None
                else self.opts.kv_transfer_timeout_s
            )
        except _FutTimeout:
            return None
        except Exception:  # noqa: BLE001 — export is best-effort: an arena
            # put or controller RPC failing mid-export must degrade the
            # handoff to colocated recompute, not fail the caller's request.
            return None
        if desc is not None:
            if trace:
                desc["trace"] = trace
            flight.record(
                "kv.export", t0, flight.now_ns(), trace=trace,
                lane="serve/engine", flow=f"disagg/{trace}" if trace else None,
                attrs={"blocks": len(desc.get("digests") or ())})
        return desc

    def _do_export(self, digests: List[bytes]) -> Optional[Dict[str, Any]]:
        """Driver-thread half of export_prompt_kv: gather block bytes (device
        blocks copied to the host at a step boundary, `_block_blobs`;
        host-tier/pending blobs as-is) and store
        them as one span-addressed arena segment. Digests no longer held
        anywhere are dropped from the descriptor — the importer recomputes
        exactly those blocks."""
        from . import kv_transfer

        with self._lock:
            srcs = self.block_manager.export_sources(digests)
        present: List[bytes] = []
        kept: List[Tuple] = []
        for h, src in zip(digests, srcs):
            if src is None:
                # A chain hole makes every later block unreachable to the
                # importer's walk — stop at the first gap.
                break
            present.append(h)
            kept.append(src)
        if not present:
            return None
        hbm_at = [i for i, s in enumerate(kept) if s[0] == "hbm"]
        hbm_blobs = (
            self._block_blobs([kept[i][1] for i in hbm_at]) if hbm_at else []
        )
        blobs: List = [None] * len(kept)
        for i, blob in zip(hbm_at, hbm_blobs):
            blobs[i] = blob
        for i, s in enumerate(kept):
            if s[0] != "hbm":
                blobs[i] = np.asarray(s[1])
        desc = kv_transfer.export_descriptor(
            present, blobs, self._kv_sig(), self.opts.block_size
        )
        if desc is not None:
            self.total_blocks_exported += len(present)
        return desc

    def import_blocks(self, desc: Optional[Dict[str, Any]]) -> int:
        """Adopt a remote replica's exported KV blocks into the local cache
        (called from any thread — the replica RPC thread during a handoff).
        Fetches bytes over the fallback ladder (same-node arena read ->
        bulk span pull -> whole-object get), ALL OR NOTHING, then registers
        each block as a cached entry whose bytes the driver thread lands
        before its next kernel. Returns the number adopted; 0 means the
        importer simply recomputes (degraded mode is the pre-disagg path)."""
        if not desc or not self.opts.enable_prefix_caching \
                or self._stop.is_set():
            return 0
        from ...util import flight

        trace = desc.get("trace")
        t0 = flight.now_ns()

        def _span(n: int, needed: int) -> int:
            flight.record(
                "kv.import", t0, flight.now_ns(), trace=trace,
                lane="serve/engine",
                flow=f"disagg/{trace}" if trace else None,
                attrs={"blocks": n, "needed": needed})
            return n

        if desc.get("sig") != self._kv_sig():
            return _span(0, 0)
        from . import kv_transfer

        with self._lock:
            # A digest already registered in HBM OR resident in the local
            # host tier needs no network fetch — allocate_cached serves the
            # tier copy as a host->HBM memcpy at admission.
            needed = [
                h for h in desc.get("digests") or []
                if self.block_manager.holds(bytes.fromhex(h)) is None
                and not (
                    self.host_tier is not None
                    and self.host_tier.contains(bytes.fromhex(h))
                )
            ]
        if not needed:
            return _span(0, 0)
        blobs = kv_transfer.fetch_blocks(
            desc, needed, timeout_s=self.opts.kv_transfer_timeout_s
        )
        if not blobs:
            return _span(0, len(needed))
        n = 0
        with self._lock:
            for hx, blob in blobs:
                h = bytes.fromhex(hx)
                if self.block_manager.holds(h) is not None:
                    # Raced in since `needed` was computed (a concurrent
                    # import of a shared prefix) — skip, keep adopting the
                    # rest: later digests may still be unique to us.
                    continue
                if self.block_manager.adopt_block(h, blob) is None:
                    break  # pool has nothing to give — the rest recompute
                n += 1
        return _span(n, len(needed))

    def _service_side_work(self):
        """Run queued export requests at the step boundary (after loads:
        freshly imported bytes are already exportable onward)."""
        while True:
            with self._lock:
                if not self._side_work:
                    return
                kind, payload, fut = self._side_work.popleft()
            try:
                result = self._do_export(payload) if kind == "export" else None
                fut.set_result(result)
            except Exception as e:  # noqa: BLE001 — fail the waiter, not the loop
                fut.set_exception(e)

    # ---------------------------------------------------------- device glue
    def _run_prefill(self, chunk):
        """One prefill chunk: compute prompt[start : start+n] into the paged
        cache. Only the FINAL chunk samples the first token (TTFT)."""
        seq = chunk.seq
        rec = self._trace_info.get(seq.request_id)
        if rec is not None and "admit_t" not in rec:
            rec["admit_t"] = time.time()
        table = self.block_manager.block_table(seq.request_id)
        L = chunk.num_tokens
        # Same bucketing primitive as the scheduler's decode shapes.
        Sp = _next_pow2(L)
        W = _next_pow2(len(table))
        tokens = np.zeros((1, Sp), np.int64)
        tokens[0, :L] = seq.prompt[chunk.start:chunk.start + L]
        bt = np.zeros((W,), np.int64)
        bt[: len(table)] = table
        logits, self.kv = self._prefill(
            self.params, self._tensor(tokens), L, chunk.start,
            self._tensor(bt), self.kv, self.cfg,
        )
        seq.num_computed = chunk.start + L
        # The chunk's KV is landed — its newly-FULL blocks are now safe to
        # serve as prefix-cache hits for later prompts.
        with self._lock:
            self.block_manager.register_computed(
                seq.request_id, seq.prompt, seq.num_computed
            )
        if chunk.last:
            self._emit(seq, self._sample(logits.cpu().numpy()))
            if rec is not None:
                rec.setdefault("first_t", time.time())
            self._maybe_finish(seq)

    def _run_verify(self, out: SchedulerOutput):
        """Speculative step: every decode lane rides ONE `verify_step_paged`
        call — lane i scores its current token plus its funded draft (other
        lanes ride along with an empty draft). Greedy acceptance: the
        longest draft prefix matching the model's own argmax is emitted,
        then one corrective (or, on full acceptance, bonus) token."""
        seqs = out.decodes
        B = out.batch_bucket
        W = out.width_bucket
        K1 = self.opts.spec_tokens + 1
        tokens = np.zeros((B, K1), np.int64)
        positions = np.zeros((B,), np.int64)
        valid_len = np.zeros((B,), np.int64)  # 0 for padding lanes
        tables = np.zeros((B, W), np.int64)   # padding lanes -> null block
        lane_drafts: List[List[int]] = []
        for i, seq in enumerate(seqs):
            d = out.drafts.get(seq.request_id, [])
            lane_drafts.append(d)
            tokens[i, 0] = seq.output[-1]
            if d:
                tokens[i, 1:1 + len(d)] = d
            positions[i] = seq.num_tokens - 1
            valid_len[i] = 1 + len(d)
            table = self.block_manager.block_table(seq.request_id)
            tables[i, : len(table)] = table
        logits, self.kv = self._verify(
            self.params, self._tensor(tokens), self._tensor(positions),
            self._tensor(valid_len), self._tensor(tables), self.kv, self.cfg,
        )
        greedy_all = logits.argmax(-1).cpu().numpy()  # [B, K1]
        for i, seq in enumerate(seqs):
            d = lane_drafts[i]
            greedy = greedy_all[i]
            emitted: List[int] = []
            accepted = 0
            for j, dt in enumerate(d):
                g = int(greedy[j])
                if g == dt:
                    emitted.append(dt)
                    accepted += 1
                else:
                    emitted.append(g)  # the corrective token
                    break
            if accepted == len(d):
                emitted.append(int(greedy[len(d)]))  # bonus token
            self.total_spec_proposed += len(d)
            self.total_spec_accepted += accepted
            self._step_spec[0] += len(d)
            self._step_spec[1] += accepted
            for tok in emitted:
                self._emit(seq, tok)
                if self._maybe_finish(seq):
                    # eos mid-span: later landed KV is garbage ABOVE the
                    # watermark — never registered, freed with the seq.
                    break

    def _run_decode(self, out: SchedulerOutput):
        if out.drafts:
            return self._run_verify(out)
        seqs = out.decodes
        B = out.batch_bucket
        W = out.width_bucket
        tokens = np.zeros((B,), np.int64)
        positions = np.zeros((B,), np.int64)
        tables = np.zeros((B, W), np.int64)  # padding lanes -> null block
        for i, seq in enumerate(seqs):
            tokens[i] = seq.output[-1]
            positions[i] = seq.num_tokens - 1   # where this token's KV lands
            table = self.block_manager.block_table(seq.request_id)
            tables[i, : len(table)] = table
        logits, self.kv = self._decode(
            self.params, self._tensor(tokens), self._tensor(positions),
            self._tensor(tables), self.kv, self.cfg,
        )
        logits = logits.cpu().numpy()
        for i, seq in enumerate(seqs):
            self._emit(seq, self._sample(logits[i]))
            self._maybe_finish(seq)

    def step(self) -> Dict[str, Any]:
        """One engine iteration; safe to drive manually (tests) or from the
        driver thread. Returns a stats snapshot."""
        t0 = time.monotonic()
        # Flight-recorder step span: one monotonic_ns read + enabled()
        # check up front; the record itself only happens on steps that did
        # work.
        from ...util import flight

        fl_on = flight.enabled()
        t0_ns = time.monotonic_ns() if fl_on else 0
        self._step_ttfts, self._step_tpots = [], []
        self._step_spec = [0, 0]  # [proposed, accepted]
        tok0 = self.total_tokens
        with self._lock:
            out = self.scheduler.schedule()
        self.total_preemptions += len(out.preempted)
        for seq in out.preempted:
            # Recompute preemption re-queues the request: its admission,
            # prefill, and first-token spans restart at the next schedule.
            rec = self._trace_info.get(seq.request_id)
            if rec is not None:
                rec.pop("admit_t", None)
                rec.pop("first_t", None)
        # Drain order is load-bearing (kv_manager header): eviction SAVES
        # read their blocks' bytes before COW copies or tier/import LOADS
        # can overwrite them, and everything lands before kernels run.
        self._apply_host_saves()
        self._apply_cow()
        self._apply_host_loads()
        self._service_side_work()
        for chunk in out.prefills:
            self._run_prefill(chunk)
        if out.decodes:
            self._run_decode(out)

        now = time.monotonic()
        self._tok_window = [t for t in self._tok_window if now - t <= 10.0]
        kv_stats = self.block_manager.stats()
        stats = {
            "queue_depth": self.scheduler.queue_depth,
            "running": self.scheduler.num_running,
            "kv_utilization": kv_stats.utilization,
            "kv_free_blocks": kv_stats.free_blocks,
            "kv_cached_blocks": kv_stats.cached_blocks,
            "prefix_cache_hits": kv_stats.hits,
            "prefix_cache_misses": kv_stats.misses,
            "prefix_cache_evictions": kv_stats.evictions,
            "host_tier_hits": kv_stats.host_hits,
            "host_tier_bytes": kv_stats.host_bytes,
            "blocks_imported": self.total_blocks_imported,
            "blocks_exported": self.total_blocks_exported,
            "step_budget_tokens": out.step_tokens,
            "tokens_per_s": (
                len(self._tok_window) / max(now - self._tok_window[0], 1e-3)
                if self._tok_window
                else 0.0
            ),
            "step_tokens": self.total_tokens - tok0,
            "step_preemptions": len(out.preempted),
            "step_prefills": len(out.prefills),
            "step_decodes": len(out.decodes),
            "step_spec_proposed": self._step_spec[0],
            "step_spec_accepted": self._step_spec[1],
            "step_ttfts": list(self._step_ttfts),
            "step_tpots": list(self._step_tpots),
            "step_s": now - t0,
        }
        if fl_on and (out.prefills or out.decodes):
            flight.record(
                "engine.step", t0_ns, time.monotonic_ns(),
                lane=f"serve/engine-{self.opts.role or 'colocated'}",
                attrs={"prefills": len(out.prefills),
                       "decodes": len(out.decodes),
                       "tokens": stats["step_tokens"]})
        self._export_metrics(stats)
        return stats

    def stats(self, include_raw: bool = False) -> Dict[str, Any]:
        """Engine counters + latency summaries. `include_raw=True` adds the
        bounded raw TTFT/TPOT windows."""
        with self._lock:
            kv_stats = self.block_manager.stats()
            ttfts = list(self._ttfts)
            tpots = list(self._tpots)
        extra = (
            {"ttft_recent": ttfts, "tpot_recent": tpots} if include_raw else {}
        )
        return {
            **extra,
            "queue_depth": self.scheduler.queue_depth,
            "running": self.scheduler.num_running,
            "kv_utilization": kv_stats.utilization,
            "kv_cached_blocks": kv_stats.cached_blocks,
            "prefix_cache_hits": kv_stats.hits,
            "prefix_cache_misses": kv_stats.misses,
            "prefix_cache_evictions": kv_stats.evictions,
            "role": self.opts.role,
            "host_tier_hits": kv_stats.host_hits,
            "host_tier_blocks": kv_stats.host_blocks,
            "host_tier_bytes": kv_stats.host_bytes,
            "blocks_imported": self.total_blocks_imported,
            "blocks_exported": self.total_blocks_exported,
            "total_tokens": self.total_tokens,
            "total_finished": self.total_finished,
            "total_preemptions": self.total_preemptions,
            "spec_proposed": self.total_spec_proposed,
            "spec_accepted": self.total_spec_accepted,
            "spec_acceptance_rate": (
                round(self.total_spec_accepted / self.total_spec_proposed, 4)
                if self.total_spec_proposed
                else None
            ),
            "ttft_p50_s": float(np.median(ttfts)) if ttfts else None,
            "ttft_p99_s": _quantile(ttfts, 0.99),
            "tpot_p50_s": float(np.median(tpots)) if tpots else None,
        }

    def fleet_state(self) -> Dict[str, Any]:
        """Bounded telemetry for routers and autoscalers: load, the
        hot-prefix digest, the TTFT tail, the recent (30 s) prefix-hit rate
        and the spec-decode acceptance rate."""
        with self._lock:
            kv_stats = self.block_manager.stats()
            digest = self.block_manager.prefix_digest(64)
            queue_depth = self.scheduler.queue_depth
            running = self.scheduler.num_running
            ttfts = list(self._ttfts)
        now = time.monotonic()
        self._hit_snaps.append((now, kv_stats.hits, kv_stats.misses))
        while self._hit_snaps and now - self._hit_snaps[0][0] > 30.0:
            self._hit_snaps.popleft()
        t0, h0, m0 = self._hit_snaps[0]
        dh, dm = kv_stats.hits - h0, kv_stats.misses - m0
        return {
            "queue_depth": queue_depth,
            "running": running,
            "free_blocks": kv_stats.free_blocks,
            "block_size": self.opts.block_size,
            "kv_utilization": kv_stats.utilization,
            "digest": digest,
            "role": self.opts.role,
            "host_tier_hits": kv_stats.host_hits,
            "host_tier_blocks": kv_stats.host_blocks,
            "host_tier_bytes": kv_stats.host_bytes,
            "ttft_p99_s": _quantile(ttfts, 0.99),
            "prefix_hit_rate": (
                round(dh / (dh + dm), 4) if (dh + dm) > 0 else None
            ),
            "spec_acceptance_rate": (
                round(self.total_spec_accepted / self.total_spec_proposed, 4)
                if self.total_spec_proposed
                else None
            ),
        }

    # -------------------------------------------------------- driver thread
    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="llm-engine"
        )
        self._thread.start()

    def shutdown(self):
        self._stop.set()
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # Fail every open stream — a consumer blocked in queue.get() would
        # otherwise hang forever once the driver thread is gone.
        with self._lock:
            outs = list(self._outputs.values())
            self._outputs.clear()
            self._trace_info.clear()
            side, self._side_work = list(self._side_work), deque()
        for out in outs:
            out._q.put(RuntimeError("engine shut down"))
        for _, _, fut in side:
            # Exporters blocked in export_prompt_kv must not wait out their
            # full transfer deadline on a dead driver thread.
            try:
                fut.set_result(None)
            except Exception:  # noqa: BLE001
                pass

    def _loop(self):
        while not self._stop.is_set():
            with self._work:
                while (
                    not self.scheduler.has_work()
                    and not self._side_work
                    and not self._stop.is_set()
                ):
                    self._work.wait(timeout=0.1)
            if self._stop.is_set():
                return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — fail every open stream
                with self._lock:
                    outs = list(self._outputs.values())
                    self._outputs.clear()
                    self._trace_info.clear()
                    # Drop all scheduler state: without it the loop would
                    # respin on the same poisoned batch forever.
                    for seq in list(self.scheduler.running):
                        self.scheduler.finish(seq, "error")
                    self.scheduler.waiting.clear()
                    self.scheduler._seqs.clear()
                for out in outs:
                    out._q.put(e)
