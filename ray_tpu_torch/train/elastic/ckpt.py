"""Async sharded checkpointing with group-commit atomicity.

Design (ISSUE 4 tentpole, plane 2; reference: TorchTitan's async DCP saves,
arXiv 2410.06511 §3):

- Each rank snapshots its shard to host memory synchronously (a CPU
  copy of each tensor, in its own dtype: the reference's numpy copy,
  `ray_tpu/train/elastic/ckpt.py:6-7`, has no bf16, and AdamW's first
  moment is bf16) and hands it to a background writer thread — the training
  step never blocks on the filesystem. `ckpt_save_overlap_seconds`
  (util/metrics.py) records how much write time was hidden behind compute.
- Layout: `<root>/step_{step:08d}.{gen}/shard_{rank:05d}.pkl`, each shard
  written tmp → fsync → atomic rename. `gen` is the gang-incarnation token
  (one per WorkerGroup start): a shard written by a PREVIOUS incarnation
  can never be mixed with this one's into a frankenstein checkpoint —
  after a crash-and-restart the same step re-saves into a fresh directory.
- Group commit: after landing its own shard, every writer checks whether
  all `world_size` shards are present; the first to observe a full set
  writes the `COMMITTED` marker (tmp → fsync → rename → dir fsync). A
  checkpoint without the marker does not exist as far as restore is
  concerned, so a SIGKILL anywhere mid-save leaves the previous committed
  checkpoint restorable (atomicity acceptance test).
- Restore reshards: mode="sharded" shards are axis-0 partitions (rank
  order); a re-formed gang with a different world size concatenates and
  re-splits. mode="replicated" loads shard 0 for every rank.

Shard payloads are pickled host pytrees — `{"tree": ..., "state": ...}`
where state is the ElasticState payload (state.py).
"""

from __future__ import annotations

import os
import pickle
import queue
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .state import ElasticState

from ..checkpoint import _fsync_dir  # the reference also takes _to_host: _snapshot copies here

COMMIT_MARKER = "COMMITTED"
_STEP_DIR_RE = re.compile(r"^step_(\d{8})\.(.+)$")


def step_dir_name(step: int, gen: str) -> str:
    return f"step_{step:08d}.{gen}"


def stage_root(root: str, stage: int) -> str:
    """Per-stage checkpoint directory of an MPMD pipeline run: each stage's
    dp replicas write their shards (rank = dp index, world = dp) under
    `<root>/stage_NN/`, so the existing axis-0 reshard machinery applies
    per stage when the pipeline reshapes to a different dp width."""
    return os.path.join(root, f"stage_{stage:02d}")


def latest_common_committed(root: str, num_stages: int):
    """Newest step committed in EVERY stage directory — the only step the
    whole pipeline can restore coherently. Per-stage group commits are
    independent (a crash can land between stage commits), so the restore
    point is the intersection of committed steps, not any one stage's
    latest. Returns (step, [stage dirs]) or None."""
    per_stage = []
    for s in range(num_stages):
        sroot = stage_root(root, s)
        committed = {
            step: path
            for step, path in ShardedCheckpoint.list_checkpoints(sroot)
            if os.path.exists(os.path.join(path, COMMIT_MARKER))
        }
        if not committed:
            return None
        per_stage.append(committed)
    common = set(per_stage[0])
    for committed in per_stage[1:]:
        common &= set(committed)
    if not common:
        return None
    step = max(common)
    return step, [per_stage[s][step] for s in range(num_stages)]


def _write_atomic(path: str, data: bytes, tmp: Optional[str] = None) -> None:
    """Write-fsync-rename. `tmp` must be unique per WRITER when several
    processes race to produce the same `path` (the group-commit marker):
    with a shared tmp name the loser's rename throws FileNotFoundError
    after the winner renames the file away."""
    tmp = tmp or (path + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def _tree_map(fn, tree):
    # torch's pytree utilities, where the reference uses jax.tree_util
    # (`ray_tpu/train/elastic/ckpt.py:99`).
    from torch.utils import _pytree as tree_util

    return tree_util.tree_map(fn, tree)


def _lens_sidecar_name(rank: int) -> str:
    return f"shard_{rank:05d}.lens.json"


def _leaf_lens(leaves) -> List[Optional[int]]:
    """Per-leaf axis-0 length, None for replicated (non-tensor / 0-d)."""
    import torch  # reference: numpy arrays (`ray_tpu/train/elastic/ckpt.py:110-114`)

    return [
        leaf.shape[0]
        if isinstance(leaf, torch.Tensor) and leaf.ndim > 0 else None
        for leaf in leaves
    ]


def _read_lens_sidecar(
    ckpt_dir: str, rank: int, nleaves: int
) -> Optional[List[Optional[int]]]:
    """Advisory fast path for reshard restore: the writer's lens sidecar,
    or None (missing/corrupt/wrong leaf count — caller unpickles the full
    shard instead)."""
    import json

    try:
        with open(os.path.join(ckpt_dir, _lens_sidecar_name(rank))) as f:
            lens = json.load(f)
    except (OSError, ValueError):
        return None
    if (
        not isinstance(lens, list)
        or len(lens) != nleaves
        or not all(v is None or isinstance(v, int) for v in lens)
    ):
        return None
    return lens


def _snapshot(tree) -> Any:
    """Host copy of every leaf — the caller may donate/mutate its arrays the
    moment save() returns, so the writer must own the bytes (a DTensor:
    its local shard); the reference takes a numpy copy (`ray_tpu/train/elastic/ckpt.py:144-148`)."""
    import torch

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        h = x.to_local() if hasattr(x, "to_local") else x
        return h.detach().to("cpu", copy=True)

    return _tree_map(copy, tree)


class ShardedCheckpoint:
    """Static helpers over one checkpoint root directory."""

    @staticmethod
    def list_checkpoints(root: str) -> List[Tuple[int, str]]:
        """All checkpoint dirs (committed or not) as (step, path), ascending
        by (step, mtime)."""
        out = []
        try:
            names = os.listdir(root)
        except OSError:
            return []
        for name in names:
            m = _STEP_DIR_RE.match(name)
            if not m:
                continue
            path = os.path.join(root, name)
            if os.path.isdir(path):
                try:
                    mtime = os.stat(path).st_mtime
                except OSError:
                    mtime = 0.0
                out.append((int(m.group(1)), path, mtime))
        out.sort(key=lambda e: (e[0], e[2]))
        return [(step, path) for step, path, _ in out]

    @staticmethod
    def latest_committed(root: str) -> Optional[Tuple[int, str]]:
        """(step, dir) of the newest checkpoint bearing the COMMITTED
        marker; uncommitted (marker-less) dirs — crashed mid-save — are
        skipped."""
        for step, path in reversed(ShardedCheckpoint.list_checkpoints(root)):
            if os.path.exists(os.path.join(path, COMMIT_MARKER)):
                return step, path
        return None

    @staticmethod
    def read_meta(ckpt_dir: str) -> Dict[str, Any]:
        import json

        with open(os.path.join(ckpt_dir, COMMIT_MARKER)) as f:
            return json.load(f)

    @staticmethod
    def load_shard(ckpt_dir: str, rank: int) -> Dict[str, Any]:
        with open(os.path.join(ckpt_dir, f"shard_{rank:05d}.pkl"), "rb") as f:
            return pickle.load(f)

    @staticmethod
    def restore(
        root: str, rank: int, world_size: int, step: Optional[int] = None
    ) -> Optional[Tuple[ElasticState, Any]]:
        """Load the latest committed checkpoint for `rank` of a gang of
        `world_size`, resharding if the checkpoint was written by a gang of
        a different size. With `step`, pin to that exact committed step
        (the MPMD restore path: every stage must load the pipeline's COMMON
        committed step, not its own latest). Returns (state, tree) or None
        when no matching committed checkpoint exists."""
        if step is None:
            found = ShardedCheckpoint.latest_committed(root)
        else:
            found = next(
                (
                    (st, path)
                    for st, path in reversed(
                        ShardedCheckpoint.list_checkpoints(root)
                    )
                    if st == step
                    and os.path.exists(os.path.join(path, COMMIT_MARKER))
                ),
                None,
            )
        if found is None:
            return None
        _, ckpt_dir = found
        meta = ShardedCheckpoint.read_meta(ckpt_dir)
        saved_world = int(meta["world_size"])
        mode = meta.get("mode", "sharded")
        if mode == "replicated":
            payload = ShardedCheckpoint.load_shard(ckpt_dir, 0)
            return ElasticState.from_payload(payload["state"]), payload["tree"]
        if saved_world == world_size:
            payload = ShardedCheckpoint.load_shard(ckpt_dir, rank)
            return ElasticState.from_payload(payload["state"]), payload["tree"]
        # Reshard: each leaf is the axis-0 concatenation across the saved
        # ranks, re-split np.array_split-style into the new world size.
        # Non-array / 0-d leaves are treated as replicated (shard 0 wins).
        # Shards are loaded ONE AT A TIME (never the whole model at once —
        # that is the memory profile sharding exists to avoid): pass 1
        # records per-leaf axis-0 lengths — from the tiny lens sidecars the
        # writers left next to each shard when available (unpickling every
        # full shard just to read shapes would put O(world x model) of
        # deserialize on the recovery path), falling back to the shard
        # payload itself for sidecar-less dirs — pass 2 re-reads only the
        # shards overlapping this rank's slice and keeps just the overlap.
        # torch tensors and torch's pytrees, where the reference slices
        # numpy arrays through jax.tree_util (`ray_tpu/train/elastic/ckpt.py:248-257`):
        # numpy has no bf16.
        import torch
        from torch.utils import _pytree as tree_util

        payload0 = ShardedCheckpoint.load_shard(ckpt_dir, 0)
        leaves0, treedef = tree_util.tree_flatten(payload0["tree"])
        state0 = payload0["state"]
        rep_leaves = []  # replicated (non-array / 0-d) leaves from shard 0
        leaf_meta = []  # (trailing shape, dtype) per leaf, for empty slices
        for leaf in leaves0:
            sharded = isinstance(leaf, torch.Tensor) and leaf.ndim > 0  # reference: np.ndarray
            rep_leaves.append(None if sharded else leaf)
            leaf_meta.append(
                (leaf.shape[1:], leaf.dtype) if sharded else None
            )
        nleaves = len(leaves0)
        per_shard_lens = [_leaf_lens(leaves0)]  # shard -> lens per leaf
        for r in range(1, saved_world):
            lens = _read_lens_sidecar(ckpt_dir, r, nleaves)
            if lens is None:
                lens = _leaf_lens(tree_util.tree_flatten(
                    ShardedCheckpoint.load_shard(ckpt_dir, r)["tree"]
                )[0])
            per_shard_lens.append(lens)
        bounds = []  # this rank's [start, end) per leaf, None if replicated
        for i in range(nleaves):
            if per_shard_lens[0][i] is None:
                bounds.append(None)
                continue
            total = sum(per_shard_lens[r][i] for r in range(saved_world))
            q, rem = divmod(total, world_size)  # np.array_split sizing
            start = rank * q + min(rank, rem)
            bounds.append((start, start + q + (1 if rank < rem else 0)))

        pieces = [[] for _ in range(nleaves)]
        offsets = [0] * nleaves
        for r in range(saved_world):
            lens = per_shard_lens[r]
            need = any(
                b is not None and lens[i] is not None
                and offsets[i] < b[1] and offsets[i] + lens[i] > b[0]
                for i, b in enumerate(bounds)
            )
            leaves = (
                tree_util.tree_flatten(
                    ShardedCheckpoint.load_shard(ckpt_dir, r)["tree"]
                )[0]
                if need else None
            )
            for i, b in enumerate(bounds):
                if b is None or lens[i] is None:
                    continue
                if leaves is not None:
                    lo = max(b[0] - offsets[i], 0)
                    hi = min(b[1] - offsets[i], lens[i])
                    if lo < hi:
                        # reference: np.asarray(...)[lo:hi].copy() (`:303`)
                        pieces[i].append(leaves[i][lo:hi].clone())
                offsets[i] += lens[i]

        out_leaves = []
        for i in range(nleaves):
            if bounds[i] is None:
                out_leaves.append(rep_leaves[i])
            elif pieces[i]:
                out_leaves.append(
                    pieces[i][0] if len(pieces[i]) == 1
                    else torch.cat(pieces[i], dim=0)  # reference: np.concatenate (`:313`)
                )
            else:  # more new ranks than rows: this rank's slice is empty
                trail, dtype = leaf_meta[i]
                out_leaves.append(torch.empty((0,) + tuple(trail), dtype=dtype))  # reference: np.empty

        # torch's tree_unflatten takes the leaves first (reference: `:319`).
        tree = tree_util.tree_unflatten(out_leaves, treedef)
        return ElasticState.from_payload(state0), tree


class AsyncShardWriter:
    """Per-rank background checkpoint writer.

    save() snapshots and enqueues (bounded queue — a writer that cannot
    keep up applies backpressure rather than buffering unbounded host
    copies); the writer thread lands the shard durably and attempts the
    group commit. flush() drains; close() drains and stops."""

    def __init__(
        self,
        root: str,
        rank: int,
        world_size: int,
        gen: str = "0",
        mode: str = "sharded",
        queue_depth: int = 2,
        commit_wait_s: float = 0.0,
        metric_tags: Optional[Dict[str, str]] = None,
        keep: Optional[int] = 3,
    ):
        if mode not in ("sharded", "replicated"):
            raise ValueError(f"unknown checkpoint mode {mode!r}")
        self.root = root
        self.rank = rank
        self.world_size = world_size
        self.gen = str(gen)
        self.mode = mode
        self.commit_wait_s = commit_wait_s
        self.metric_tags = dict(metric_tags or {})
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        # Pending = enqueued-but-not-yet-landed saves. A plain "queue empty
        # + idle flag" protocol has a window (between dequeue and
        # flag-clear) where flush() could return with a shard mid-write;
        # the counter is decremented only AFTER the shard landed.
        self._pending = 0
        self._cv = threading.Condition()
        self._stop = False
        self._error: Optional[BaseException] = None
        self.saves = 0
        self.commits = 0
        self.last_block_s = 0.0  # time save() spent blocking the step
        self.last_write_s = 0.0  # write time hidden behind training
        self._thread = threading.Thread(
            target=self._run, name=f"elastic-ckpt-w{rank}", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------------- API
    def save(self, step: int, tree: Any, state: ElasticState) -> None:
        """Snapshot + enqueue; returns as soon as the host copy is made."""
        if self._error is not None:
            raise RuntimeError("checkpoint writer failed") from self._error
        t0 = time.monotonic()
        snap = _snapshot(tree)
        payload = {"tree": snap, "state": state.to_payload()}
        with self._cv:
            self._pending += 1
        self._q.put((step, payload))  # blocks only when queue_depth exceeded
        self.last_block_s = time.monotonic() - t0
        self.saves += 1

    def flush(self, timeout: float = 60.0) -> bool:
        """Wait until every enqueued save has landed (and commit was
        attempted). Returns False on timeout; raises when the writer
        failed — a shard that never hit disk must not read as a successful
        flush (the failed save would otherwise only surface if another
        save() happened to follow)."""
        with self._cv:
            done = self._cv.wait_for(lambda: self._pending == 0, timeout)
        if self._error is not None:
            raise RuntimeError("checkpoint writer failed") from self._error
        return done

    def close(self, timeout: float = 60.0) -> None:
        """Drain and stop. Raises when the writer failed OR the drain timed
        out — queued shards abandoned by the shutdown must surface as a
        failure (worker_group treats a raising close() as worker error),
        never as a successful finish with silently-missing checkpoints."""
        try:
            if not self.flush(timeout):
                raise RuntimeError(
                    f"checkpoint writer drain timed out after {timeout}s; "
                    "queued shards were abandoned"
                )
        finally:
            self._shutdown_thread()

    def _shutdown_thread(self) -> None:
        self._stop = True
        try:
            self._q.put_nowait(None)  # wake a get()-blocked thread
        except queue.Full:
            pass  # thread is mid-item; it observes _stop on its next loop
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------- worker
    def _run(self):
        while True:
            item = self._q.get()
            if item is None or self._stop:
                # Account for every save we are abandoning (this item and
                # anything still queued) so a late flush() doesn't wait out
                # its full timeout on work that will never happen.
                with self._cv:
                    if item is not None:
                        self._pending -= 1
                    while True:
                        try:
                            dropped = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if dropped is not None:
                            self._pending -= 1
                    self._cv.notify_all()
                return
            step, payload = item
            t0 = time.monotonic()
            try:
                self._write_shard(step, payload)
            except BaseException as e:  # noqa: BLE001 — surfaced on next save()
                self._error = e
            self.last_write_s = time.monotonic() - t0
            try:
                from ...util import metrics as _m

                _m.elastic_metrics()["ckpt_save_overlap_seconds"].observe(
                    self.last_write_s, tags=self.metric_tags
                )
            except Exception:  # noqa: BLE001 — metrics never load-bearing
                pass
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()

    def _write_shard(self, step: int, payload: Dict[str, Any]) -> None:
        import json

        # torch's pytrees, where the reference uses jax.tree_util
        # (`ray_tpu/train/elastic/ckpt.py:462`).
        from torch.utils import _pytree as tree_util

        ckpt_dir = os.path.join(self.root, step_dir_name(step, self.gen))
        os.makedirs(ckpt_dir, exist_ok=True)
        shard_path = os.path.join(ckpt_dir, f"shard_{self.rank:05d}.pkl")
        _write_atomic(shard_path, pickle.dumps(payload))
        # Lens sidecar: reshard restore's pass 1 reads per-leaf axis-0
        # lengths from this tiny JSON instead of unpickling the full shard.
        # Written AFTER the shard (a sidecar without its shard would be a
        # lie; the reverse just falls back to the slow path).
        _write_atomic(
            os.path.join(ckpt_dir, _lens_sidecar_name(self.rank)),
            json.dumps(
                _leaf_lens(tree_util.tree_flatten(payload["tree"])[0])
            ).encode(),
        )
        _fsync_dir(ckpt_dir)
        if self._try_commit(step, ckpt_dir):
            self._prune()

    def _prune(self) -> None:
        """Retention: keep the newest `keep` COMMITTED checkpoints and drop
        every dir (committed or not, any incarnation) strictly older than
        the oldest kept one — per-step saves would otherwise grow the disk
        without bound, and marker-less partials from dead incarnations
        would accumulate forever. Dirs newer than the threshold are left
        alone (an in-progress save must not be yanked mid-write). Every
        rank's writer prunes; the racing rmtrees are idempotent."""
        if self.keep is None:
            return
        import shutil

        committed = [
            (step, path)
            for step, path in ShardedCheckpoint.list_checkpoints(self.root)
            if os.path.exists(os.path.join(path, COMMIT_MARKER))
        ]
        if len(committed) <= self.keep:
            return
        threshold = committed[-self.keep][0]
        for step, path in ShardedCheckpoint.list_checkpoints(self.root):
            if step < threshold:
                shutil.rmtree(path, ignore_errors=True)

    def _try_commit(self, step: int, ckpt_dir: str) -> bool:
        """Write the group-commit marker iff every rank's shard has landed
        in THIS incarnation's directory. Every writer races to commit; the
        marker rename is atomic and idempotent, so double-commit is
        harmless. With commit_wait_s > 0 the writer lingers briefly for
        stragglers (useful when only one rank checkpoints frequently)."""
        marker = os.path.join(ckpt_dir, COMMIT_MARKER)
        deadline = time.monotonic() + self.commit_wait_s
        while True:
            if os.path.exists(marker):
                return True
            have = all(
                os.path.exists(os.path.join(ckpt_dir, f"shard_{r:05d}.pkl"))
                for r in range(self.world_size)
            )
            if have:
                import json

                meta = {
                    "step": step,
                    "world_size": self.world_size,
                    "mode": self.mode,
                    "gen": self.gen,
                    "ts": time.time(),
                }
                try:
                    _write_atomic(
                        marker, json.dumps(meta).encode(),
                        tmp=f"{marker}.tmp.{self.rank}",
                    )
                except OSError:
                    # Lost the commit race to another rank's writer — fine,
                    # the marker exists either way.
                    if not os.path.exists(marker):
                        raise
                _fsync_dir(ckpt_dir)
                self.commits += 1
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
