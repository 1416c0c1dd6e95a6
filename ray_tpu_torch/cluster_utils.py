"""Multi-node-on-one-machine test cluster.

Reference analog: `python/ray/cluster_utils.py:108` `Cluster`/`add_node` —
the fixture behind all of the reference's multi-node CI (SURVEY.md §4): N
node daemons as separate processes on one machine with fake resources.

Usage:
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2, resources={"worker1": 1})
    ray_tpu_torch.init(address=cluster.address)
    ...
    cluster.shutdown()
"""

from __future__ import annotations

import json
import os
import selectors
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import cloudpickle

from .core.cluster_backend import ClusterBackend
from .core.rpc import ensure_auth_token


def read_sentinel(proc: subprocess.Popen, prefix: str, timeout: float) -> Optional[str]:
    """Read stdout lines until one starts with `prefix`; honors the deadline
    even when the child stays alive but silent (poll before readline).
    selectors (epoll), not select(): a driver holding thousands of direct
    worker channels has fds past select()'s 1024 cap, and a HEAD RESTART is
    exactly when such a driver calls this."""
    deadline = time.monotonic() + timeout
    buf = b""
    fd = proc.stdout.fileno()
    sel = selectors.DefaultSelector()
    sel.register(fd, selectors.EVENT_READ)
    try:
        while time.monotonic() < deadline:
            if proc.poll() is not None and not buf:
                return None
            ready = sel.select(min(0.5, max(0.01, deadline - time.monotonic())))
            if not ready:
                continue
            chunk = os.read(fd, 4096)
            if not chunk:
                if proc.poll() is not None:
                    return None
                continue
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                text = line.decode(errors="replace")
                if text.startswith(prefix):
                    return text[len(prefix):].strip()
        return None
    finally:
        sel.close()


def launch_node_agent(
    address: str,
    session_dir: str,
    node_id: str,
    resources: Dict[str, float],
    object_store_memory: Optional[int] = None,
    wait_ready: bool = True,
    labels: Optional[Dict[str, str]] = None,
    node_ip: Optional[str] = None,
) -> subprocess.Popen:
    """Spawn one `node_agent` daemon process joining the cluster at
    `address`. Shared by the test `Cluster` fixture and the autoscaler's
    `FakeMultiNodeProvider` (reference analog: the fake multinode provider
    launching raylets as local processes —
    `autoscaler/_private/fake_multi_node/node_provider.py`)."""
    args = {
        "node_id": node_id,
        "address": address,
        "resources": resources,
        "session_dir": session_dir,
        "object_store_memory": object_store_memory,
        "labels": labels or {},
        "node_ip": node_ip,
    }
    ensure_auth_token()
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    env["RAY_TPU_NODE_ARGS"] = json.dumps(args)
    log_f = open(os.path.join(session_dir, f"agent-{node_id}.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.node_agent"],
        env=env,
        stdout=subprocess.PIPE,
        stderr=log_f,
        cwd=pkg_root,
    )
    if wait_ready and read_sentinel(proc, "RAY_TPU_NODE_READY=", 30) is None:
        proc.terminate()
        raise RuntimeError(
            f"node {node_id} failed to start; see {session_dir}/agent-{node_id}.log"
        )
    return proc


@dataclass
class NodeHandle:
    node_id: str
    process: subprocess.Popen
    resources: Dict[str, float] = field(default_factory=dict)

    @property
    def alive(self) -> bool:
        return self.process.poll() is None


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: Optional[dict] = None,
    ):
        self.address: Optional[str] = None
        self.session_dir: Optional[str] = None
        self.head_proc: Optional[subprocess.Popen] = None
        self.nodes: List[NodeHandle] = []
        self._node_counter = 0
        if initialize_head:
            args = head_node_args or {}
            self._start_head(
                num_cpus=args.get("num_cpus", 2),
                resources=args.get("resources", {}),
                object_store_memory=args.get("object_store_memory"),
            )

    # -------------------------------------------------------------- head
    def _start_head(self, num_cpus, resources, object_store_memory,
                    restore=False, sentinel_timeout=60):
        if self.session_dir is None:
            from .core.host_names import SESSION_ROOT  # (reference: "/tmp/ray_tpu", ray_tpu/cluster_utils.py:146)

            self.session_dir = os.path.join(
                SESSION_ROOT, f"cluster_{int(time.time() * 1000)}_{os.getpid()}"
            )
        os.makedirs(self.session_dir, exist_ok=True)
        self._head_args = (num_cpus, resources, object_store_memory)
        ensure_auth_token()  # controller + agents + drivers share the secret
        args = {
            "num_cpus": float(num_cpus),
            "resources": resources,
            "session_dir": self.session_dir,
            "object_store_memory": object_store_memory,
            "port": 0,
            "restore": restore,
            "standalone": True,  # the cluster owns the lifetime, not drivers
        }
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_CONTROLLER_ARGS"] = cloudpickle.dumps(args).hex()
        log_f = open(os.path.join(self.session_dir, "controller.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.controller_main"],
            env=env,
            stdout=subprocess.PIPE,
            stderr=log_f,
            cwd=pkg_root,
        )
        val = read_sentinel(proc, "RAY_TPU_CONTROLLER_PORT=", sentinel_timeout)
        if val is None:
            proc.terminate()
            raise RuntimeError(
                f"cluster head failed to start; see {self.session_dir}/controller.log"
            )
        port = int(val)
        self.head_proc = proc
        from .core import config as rt_config

        self.address = f"{rt_config.get('node_ip')}:{port}"

    def kill_head(self):
        """kill -9 the controller (GCS-FT chaos; workers survive — they are
        orphaned, not PDEATHSIG-bound like node-agent workers)."""
        if self.head_proc is not None and self.head_proc.poll() is None:
            self.head_proc.kill()
            self.head_proc.wait(timeout=10)

    def restart_head(self):
        """Restart the controller against the same session dir: it restores
        the checkpoint + replays the WAL, re-binds its port, and re-adopts
        surviving actor workers as they reconnect. Generous sentinel: the
        restarting head competes for CPU with every orphaned worker's
        reconnect loop (a 2,000-worker fleet on a small host can stretch a
        ~2s interpreter boot past a minute of wall time)."""
        num_cpus, resources, object_store_memory = self._head_args
        self._start_head(num_cpus, resources, object_store_memory,
                         restore=True, sentinel_timeout=180)

    # ------------------------------------------------------------- nodes
    def add_node(
        self,
        num_cpus: float = 1.0,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        node_id: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> NodeHandle:
        assert self.address, "head not started"
        self._node_counter += 1
        node_id = node_id or f"node{self._node_counter}"
        total = {"CPU": float(num_cpus), **(resources or {})}
        proc = launch_node_agent(
            self.address, self.session_dir, node_id, total, object_store_memory,
            labels=labels,
        )
        handle = NodeHandle(node_id=node_id, process=proc, resources=total)
        self.nodes.append(handle)
        return handle

    def remove_node(self, node: NodeHandle, allow_graceful: bool = False):
        """Kill a node (agent + its workers die together via PDEATHSIG)."""
        if node.process.poll() is None:
            if allow_graceful:
                node.process.terminate()
            else:
                node.process.kill()
            try:
                node.process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                node.process.kill()
        if node in self.nodes:
            self.nodes.remove(node)

    # ----------------------------------------------------------- teardown
    def shutdown(self):
        for node in list(self.nodes):
            self.remove_node(node, allow_graceful=True)
        if self.head_proc is not None and self.head_proc.poll() is None:
            try:
                backend = ClusterBackend(self.address)
                backend._connect(register_as="register_client")
                backend._request({"type": "shutdown"}, timeout=2)
                backend.conn.close()
                backend.io.stop()
            except Exception:  # noqa: BLE001
                pass
            try:
                self.head_proc.wait(timeout=8)
            except subprocess.TimeoutExpired:
                self.head_proc.terminate()
        self.head_proc = None
