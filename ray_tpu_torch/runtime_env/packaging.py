"""Content-addressed packaging of working_dir / py_modules.

Reference analog: `python/ray/_private/runtime_env/packaging.py` — local
directories are zipped under a content hash (`pkg-<sha>.zip`), shipped via
GCS there / the shared session package root here, and unpacked once per node
into a cache keyed by the same hash.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import zipfile
from typing import Iterable, Optional

DEFAULT_EXCLUDES = ("__pycache__", ".git", ".venv", "*.pyc")
MAX_PACKAGE_BYTES = 512 * 1024 * 1024


def _excluded(name: str, excludes: Iterable[str]) -> bool:
    import fnmatch

    return any(fnmatch.fnmatch(name, pat) for pat in excludes)


def _walk_files(root: str, excludes: Iterable[str]):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not _excluded(d, excludes))
        for fn in sorted(filenames):
            if not _excluded(fn, excludes):
                yield os.path.join(dirpath, fn)


def hash_directory(path: str, excludes: Iterable[str] = DEFAULT_EXCLUDES) -> str:
    """Stable content hash over relative paths + file bytes."""
    h = hashlib.sha256()
    for fp in _walk_files(path, excludes):
        rel = os.path.relpath(fp, path)
        h.update(rel.encode())
        with open(fp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()[:16]


# (path, excludes, pkg_root) -> (mtime signature, zip path). Submitting the
# same runtime_env in a loop must not re-read the whole directory per task —
# the cheap stat-based signature detects changes; content bytes are only
# re-hashed when it moves.
_PKG_CACHE: dict = {}


def _stat_signature(path: str, excludes: Iterable[str]) -> tuple:
    sig = []
    for fp in _walk_files(path, excludes):
        st = os.stat(fp)
        sig.append((os.path.relpath(fp, path), st.st_size, st.st_mtime_ns))
    return tuple(sig)


def package_directory(
    path: str,
    pkg_root: str,
    excludes: Optional[Iterable[str]] = None,
) -> str:
    """Zip `path` into `<pkg_root>/pkg-<hash>.zip` (idempotent); returns the
    zip path. Raises on oversized packages (reference has the same guard)."""
    excludes = tuple(excludes or DEFAULT_EXCLUDES)
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory does not exist: {path}")
    os.makedirs(pkg_root, exist_ok=True)
    cache_key = (path, excludes, pkg_root)
    sig = _stat_signature(path, excludes)
    cached = _PKG_CACHE.get(cache_key)
    if cached is not None and cached[0] == sig and os.path.exists(cached[1]):
        return cached[1]
    digest = hash_directory(path, excludes)
    zip_path = os.path.join(pkg_root, f"pkg-{digest}.zip")
    if os.path.exists(zip_path):
        _PKG_CACHE[cache_key] = (sig, zip_path)
        return zip_path
    import threading
    import uuid

    tmp = (
        f"{zip_path}.tmp.{os.getpid()}.{threading.get_ident()}."
        f"{uuid.uuid4().hex[:6]}"
    )
    total = 0
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
        for fp in _walk_files(path, excludes):
            total += os.path.getsize(fp)
            if total > MAX_PACKAGE_BYTES:
                zf.close()
                os.remove(tmp)
                raise ValueError(
                    f"runtime_env package for {path} exceeds "
                    f"{MAX_PACKAGE_BYTES >> 20} MiB"
                )
            zf.write(fp, os.path.relpath(fp, path))
    os.replace(tmp, zip_path)
    _PKG_CACHE[cache_key] = (sig, zip_path)
    return zip_path


def ensure_unpacked(zip_path: str, cache_root: str) -> str:
    """Unpack `pkg-<hash>.zip` into `<cache_root>/<hash>/` exactly once
    (atomic rename makes concurrent workers race-safe); returns the dir."""
    name = os.path.splitext(os.path.basename(zip_path))[0]
    target = os.path.join(cache_root, name)
    if os.path.isdir(target):
        return target
    os.makedirs(cache_root, exist_ok=True)
    tmp = f"{target}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    with zipfile.ZipFile(zip_path) as zf:
        # Zip-slip guard: every member must resolve INSIDE the target dir
        # (the package root is shared across jobs — a crafted archive must
        # not write elsewhere via absolute paths or '..' components).
        root = os.path.realpath(tmp)
        for member in zf.namelist():
            dest = os.path.realpath(os.path.join(root, member))
            if dest != root and not dest.startswith(root + os.sep):
                raise ValueError(
                    f"unsafe member path {member!r} in {zip_path}"
                )
        zf.extractall(tmp)
    try:
        os.rename(tmp, target)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)  # another worker won the race
    return target
