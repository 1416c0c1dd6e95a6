"""Checkpoint: a directory handle with to/from-pytree helpers.

Reference analog: `ray.train.Checkpoint` (`python/ray/air/checkpoint.py`) —
a movable directory. Pytrees of torch tensors save with `torch.save`, on
the CPU, each tensor in its own dtype (bf16 stays bf16); a DTensor saves
its local shard. (The reference, `ray_tpu/train/checkpoint.py:1-6`, saves
jax pytrees through orbax.)
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Dict, Optional


class Checkpoint:
    def __init__(self, path: str):
        self.path = path

    # ----------------------------------------------------------- factories
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rtpu-ckpt-")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    @classmethod
    def from_pytree(cls, tree: Any, path: Optional[str] = None) -> "Checkpoint":
        """Save a pytree of tensors with torch.save (the reference,
        `ray_tpu/train/checkpoint.py:36-54`, uses orbax, else pickle)."""
        from torch.utils import _pytree as pytree

        import torch

        d = path or tempfile.mkdtemp(prefix="rtpu-ckpt-")
        os.makedirs(d, exist_ok=True)
        torch.save(pytree.tree_map(_to_host, tree), os.path.join(d, "pytree.pt"))
        return cls(d)

    # ------------------------------------------------------------ accessors
    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def to_pytree(self, template: Any = None) -> Any:
        """The saved pytree, on the CPU; with `template` (a tree of the same
        structure) each tensor goes to its template leaf's device (the
        reference, `ray_tpu/train/checkpoint.py:62-70`, restores through
        orbax)."""
        from torch.utils import _pytree as pytree

        import torch

        tree = torch.load(os.path.join(self.path, "pytree.pt"), map_location="cpu", weights_only=False)
        if template is None:
            return tree
        return pytree.tree_map(_to_template, tree, template)

    def as_directory(self) -> str:
        return self.path

    def __repr__(self) -> str:
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


def _to_host(x):
    """A tensor detached on the CPU, in its own dtype (a DTensor: its local
    shard); anything else as is. The reference (`ray_tpu/train/checkpoint.py:82`)
    takes np.asarray, which has no bf16."""
    import torch

    if not isinstance(x, torch.Tensor):
        return x
    if hasattr(x, "to_local"):
        x = x.to_local()
    return x.detach().cpu()


def _to_template(x, like):
    """A loaded leaf on its template leaf's device."""
    import torch

    if not isinstance(x, torch.Tensor) or not isinstance(like, torch.Tensor):
        return x
    return x.to(like.device)


MANAGER_COMMIT_MARKER = ".committed"


class CheckpointManager:
    """Keeps top-k checkpoints by score (reference:
    `train/_internal/checkpoint_manager.py`).

    Registration is crash-safe: the incoming checkpoint is copied to a
    `.tmp` sibling, fsynced, and atomically renamed into place — the commit
    marker (written before the rename, so a renamed dir always carries it)
    is what `resume_latest` trusts; a crash mid-copy leaves only a `.tmp`
    dir that no resume path ever reads. Eviction of the displaced top-k
    entry happens only AFTER the new checkpoint has committed."""

    def __init__(self, directory: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max"):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries = []  # (score, path, metrics, order)
        # Adopt a previous process's checkpoints: a resumed run registering
        # from 1 would rmtree the dead run's committed checkpoint_000001
        # and leave resume_latest() preferring the dead run's higher
        # numbers over the live run's fresh checkpoints — and entries left
        # out of the table would be invisible to _evict, stranding up to
        # num_to_keep extra dirs per restart forever. Adoption informs
        # NUMBERING and EVICTION only: latest()/best() see this process's
        # registrations, so a fresh run in a reused directory never has a
        # mid-run failure silently restore the previous run's weights
        # (cross-process resume stays explicit, via resume_latest()).
        self._adopted_through = 0  # orders <= this are adopted, not ours
        self._counter = 0
        for order, path, committed in _scan_checkpoints(directory):
            self._counter = max(self._counter, order)
            if not committed:
                continue  # uncommitted: not a checkpoint (resume_latest agrees)
            metrics: Dict[str, Any] = {}
            try:
                with open(os.path.join(path, "metrics.json")) as f:
                    metrics = json.load(f).get("metrics", {})
            except (OSError, ValueError):
                pass
            score = (
                metrics.get(self.score_attribute)
                if self.score_attribute
                else order
            )
            self._entries.append((score, path, metrics, order))
        self._adopted_through = self._counter

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> str:
        self._counter += 1
        dest = os.path.join(self.directory, f"checkpoint_{self._counter:06d}")
        meta = json.dumps({"metrics": _json_safe(metrics), "ts": time.time()})
        if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
            tmp = dest + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            shutil.copytree(checkpoint.path, tmp)
            _write_file_synced(os.path.join(tmp, "metrics.json"), meta)
            _write_file_synced(os.path.join(tmp, MANAGER_COMMIT_MARKER), "")
            _fsync_tree(tmp)
            if os.path.exists(dest):  # stale dir from a crashed predecessor
                shutil.rmtree(dest)
            os.rename(tmp, dest)
            _fsync_dir(self.directory)
        else:
            _write_file_synced(os.path.join(dest, "metrics.json"), meta)
            # Same durability barrier as the copy branch: the payload must
            # be on disk BEFORE the marker makes resume_latest() trust it.
            _fsync_tree(dest)
            _write_file_synced(os.path.join(dest, MANAGER_COMMIT_MARKER), "")
            _fsync_dir(self.directory)
        score = metrics.get(self.score_attribute) if self.score_attribute else self._counter
        self._entries.append((score, dest, dict(metrics), self._counter))
        # Only now — with the new checkpoint durably committed — may the
        # displaced top-k entry be evicted (evicting first would leave zero
        # restorable checkpoints if the copy crashed).
        self._evict()
        return dest

    def _ranked(self):
        """Entries best-first; missing scores always rank WORST; score ties
        break toward the NEWER registration (ties must not evict the most
        recent checkpoint — it is what resume paths want)."""
        reverse = self.score_order == "max"
        if reverse:
            key = lambda e: (e[0] is not None, e[0] if e[0] is not None else 0, e[3])  # noqa: E731
        else:
            key = lambda e: (e[0] is None, e[0] if e[0] is not None else 0, -e[3])  # noqa: E731
        return sorted(self._entries, key=key, reverse=reverse)

    def _evict(self):
        if self.num_to_keep is None or len(self._entries) <= self.num_to_keep:
            return
        ranked = self._ranked()
        keep = ranked[: self.num_to_keep]
        # The newest OWN registration is never evicted: latest() excludes
        # adopted entries, so letting a better-scored adopted checkpoint
        # displace this run's only registration would leave latest()=None
        # (and register() returning an already-deleted path) — a restart
        # would silently lose all of this run's progress.
        own = self._own()
        newest_own = max(own, key=lambda e: e[3]) if own else None
        if newest_own is not None and newest_own not in keep:
            keep = keep[:-1] + [newest_own]
        for entry in self._entries:
            if entry not in keep:
                shutil.rmtree(entry[1], ignore_errors=True)
        # Preserve registration order so latest() means "most recent", not
        # "lowest-ranked survivor".
        self._entries = sorted(keep, key=lambda e: e[3])

    def _own(self):
        """This process's registrations (adopted entries excluded)."""
        return [e for e in self._entries if e[3] > self._adopted_through]

    def best(self) -> Optional[Checkpoint]:
        own = self._own()
        if not own:
            return None
        ranked = [e for e in self._ranked() if e[3] > self._adopted_through]
        return Checkpoint(ranked[0][1])

    def latest(self) -> Optional[Checkpoint]:
        own = self._own()
        if not own:
            return None
        return Checkpoint(max(own, key=lambda e: e[3])[1])


def _scan_checkpoints(directory: str):
    """Yield (order, path, committed) for every `checkpoint_NNNNNN` dir,
    ascending by order; `.tmp` staging dirs are skipped. The ONE place the
    manager-dir naming/commit protocol is parsed — CheckpointManager
    adoption and resume_latest() must never disagree about which
    checkpoints exist."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return
    for name in names:
        if not name.startswith("checkpoint_") or name.endswith(".tmp"):
            continue
        path = os.path.join(directory, name)
        if not os.path.isdir(path):
            continue
        try:
            order = int(name[len("checkpoint_"):])
        except ValueError:
            continue
        committed = os.path.exists(os.path.join(path, MANAGER_COMMIT_MARKER))
        yield order, path, committed


def resume_latest(directory: str) -> Optional[Checkpoint]:
    """Cross-process resume helper: newest COMMITTED checkpoint under a
    CheckpointManager directory. Skips `.tmp` dirs and any dir without the
    commit marker (a crash mid-registration) — those are not checkpoints,
    whatever their names claim."""
    best = None
    for order, path, committed in _scan_checkpoints(directory):
        if committed and (best is None or order > best[0]):
            best = (order, path)
    return Checkpoint(best[1]) if best else None


def _write_file_synced(path: str, data: str) -> None:
    with open(path, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(root: str) -> None:
    """fsync every file + dir under root (pre-rename durability barrier)."""
    for dirpath, _, filenames in os.walk(root):
        for fn in filenames:
            try:
                fd = os.open(os.path.join(dirpath, fn), os.O_RDONLY)
            except OSError:
                continue
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        _fsync_dir(dirpath)


def _json_safe(d):
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out
