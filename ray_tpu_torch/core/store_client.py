"""Pluggable control-plane metadata storage.

Reference analog: `src/ray/gcs/store_client` — `InMemoryStoreClient`
(`in_memory_store_client.h:31`, no durability) vs `RedisStoreClient`
(`redis_store_client.h:33`, enables GCS fault tolerance via replay of
`gcs_init_data.cc`). Here the durable backend is filesystem-based (point the
session dir at NFS for off-box durability); a Redis client would slot in
behind the same three-method interface but is out of scope for this image
(no redis server).

URL scheme (config flag `gcs_storage`):
    memory://          volatile — controller restart loses all state
    file://<dir>       durable  — atomic per-key files (default: session dir)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


class StoreClient:
    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self) -> List[str]:
        raise NotImplementedError


class InMemoryStoreClient(StoreClient):
    """Volatile (reference: `InMemoryStoreClient`) — controller fault
    tolerance is disabled with this backend."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}

    def put(self, key, value):
        self._data[key] = value

    def get(self, key):
        return self._data.get(key)

    def delete(self, key):
        self._data.pop(key, None)

    def keys(self):
        return list(self._data)


class FileStoreClient(StoreClient):
    """Durable per-key files with atomic replace (kill -9 safe) — fills the
    reference's Redis role for single-machine / shared-filesystem clusters."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_")
        return os.path.join(self.root, f"{safe}.bin")

    def put(self, key, value):
        tmp = f"{self._path(key)}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(value)
            # fsync BEFORE the rename: checkpoint durability is load-bearing
            # now that a landed checkpoint licenses WAL compaction — with
            # delayed allocation, a machine crash after the rename could
            # otherwise surface a zero-length checkpoint AFTER the covered
            # log segments were unlinked (unbounded loss, not the documented
            # fsync-window bound). The rename itself is fsync'd via the dir.
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(key))
        try:
            dirfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:
            pass  # non-POSIX dir fsync; the file itself is durable

    def get(self, key):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def keys(self):
        return [
            name[: -len(".bin")]
            for name in os.listdir(self.root)
            if name.endswith(".bin")
        ]


def make_store_client(url: str, default_dir: str) -> StoreClient:
    if url in ("", "file", "file://"):
        return FileStoreClient(os.path.join(default_dir, "gcs"))
    if url.startswith("file://"):
        return FileStoreClient(url[len("file://"):])
    if url in ("memory", "memory://"):
        return InMemoryStoreClient()
    if url.startswith("redis://"):
        raise ValueError(
            "redis gcs_storage is not available in this image; use "
            "file://<shared-dir> for durable multi-host metadata"
        )
    raise ValueError(f"unknown gcs_storage url: {url!r}")
