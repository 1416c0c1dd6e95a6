"""Names the runtime claims on the host, kept apart from the reference's so
that a cluster of this package, one of `ray_tpu`, and clusters of other
checkouts of this package (each with its own TMPDIR) run side by side on one
machine without adopting each other's auth token or sweeping each other's
shared memory.

(reference: a fixed root in /tmp, ray_tpu/core/controller.py:1075, and the
segment prefix `rtpu-`, ray_tpu/core/store.py:37)
"""

import hashlib
import os
import tempfile

# A session dir holds the forkserver's Unix socket
# (`<root>/session_<ms>_<pid>/forkserver-<node>.sock.tmp`), whose path may
# not pass 107 bytes: a root longer than this leaves it no room.
_MAX_ROOT = 48


def _session_root() -> str:
    root = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    if len(root.encode()) <= _MAX_ROOT:
        return root
    # A TMPDIR too deep for the socket: a short root of its own under /tmp.
    return f"/tmp/ray_tpu_torch-{hashlib.sha1(root.encode()).hexdigest()[:12]}"


# Session dirs, the `session_latest` link (with the auth token's
# address.json) and the restorable markers.
SESSION_ROOT = _session_root()

# Shared-memory segments: `/dev/shm/rtput-<controller pid>-...`. Startup
# cleanup sweeps only this prefix, so neither package unlinks the other's.
SHM_PREFIX = "rtput-"
