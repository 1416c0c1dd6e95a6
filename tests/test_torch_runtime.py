"""The port's copy of the runtime (`ray_tpu_torch.core`, `.dag`,
`.experimental`), after `tests/test_basic.py`, `test_actor.py` and
`test_dag.py`: objects, tasks, actors, `wait`, errors and a compiled DAG,
in local mode and in cluster mode (processes); and, in cluster mode, the
GPU-worker plumbing without a card: `init(num_gpus=1)` advertises a GPU, a
`num_gpus=1` task runs in a worker forked from the template (which imported
torch without touching CUDA) and given the card, every other worker is
forked from it and given none.

One runtime per mode for the whole module (the fixtures are here, not in
`tests/conftest.py`, which belongs to the reference)."""

import os
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core.host_names import SESSION_ROOT
from ray_tpu_torch.dag import InputNode, MultiOutputNode


@pytest.fixture(scope="module", params=["local", "cluster"])
def mode(request):
    if request.param == "local":
        rt.init(local_mode=True)
    else:
        rt.init(num_cpus=2, num_gpus=1)
    try:
        yield request.param
    finally:
        rt.shutdown()


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def fail(msg):
    raise RuntimeError(msg)


@rt.remote
def fan_out(n):
    """A task that submits tasks and waits on them (nested refs)."""
    return sum(rt.get([add.remote(i, i) for i in range(n)]))


@rt.remote
def sleep_then(x, s):
    time.sleep(s)
    return x


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.value = start

    def increment(self, by=1):
        self.value += by
        return self.value


@rt.remote
class Stage:
    def __init__(self, scale):
        self.scale = scale

    def fwd(self, x):
        return x * self.scale


@rt.remote
def worker_probe():
    """What a CPU task's worker sees."""
    from ray_tpu_torch.core import forkserver

    return {
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "cuda_available": torch.cuda.is_available(),
        "session_dir": os.environ.get("RAY_TPU_SESSION_DIR"),
        "template": dict(forkserver.TEMPLATE_REPORT),
        "jax": "jax" in sys.modules,
        "reference": sorted(m for m in sys.modules if m == "ray_tpu" or m.startswith("ray_tpu.")),
    }


@rt.remote(num_gpus=1)
def gpu_probe():
    from ray_tpu_torch.core import forkserver

    return {
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "accelerator_worker": os.environ.get("RAY_TPU_WORKER_TPU"),
        "template": dict(forkserver.TEMPLATE_REPORT),
    }


def test_put_get(mode):
    assert rt.get(rt.put({"a": 1})) == {"a": 1}
    x = np.arange(1000, dtype=np.float32)
    np.testing.assert_array_equal(rt.get(rt.put(x)), x)
    t = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    assert torch.equal(rt.get(rt.put(t)), t)


def test_tasks_and_nested_refs(mode):
    a = add.remote(1, 2)
    b = add.remote(a, 10)  # a ref as an argument
    assert rt.get(b) == 13
    assert rt.get(fan_out.remote(5)) == 20  # tasks submitted from a task
    assert rt.get([add.remote(i, 1) for i in range(4)]) == [1, 2, 3, 4]


def test_task_error_propagates(mode):
    with pytest.raises(RuntimeError, match="boom") as info:
        rt.get(fail.remote("boom"))
    assert isinstance(info.value, rt.TaskError)
    with pytest.raises(RuntimeError, match="chained"):
        rt.get(add.remote(fail.remote("chained"), 1))


def test_wait(mode):
    fast, slow = sleep_then.remote(1, 0.0), sleep_then.remote(2, 4.0)
    assert rt.get(fast) == 1
    ready, pending = rt.wait([fast, slow], num_returns=1, timeout=1.0)
    assert ready == [fast] and pending == [slow]
    with pytest.raises(rt.GetTimeoutError):
        rt.get(slow, timeout=0.1)
    assert rt.get(slow) == 2


def test_actors(mode):
    c = Counter.remote(10)
    assert rt.get([c.increment.remote() for _ in range(20)]) == list(range(11, 31))
    named = Counter.options(name=f"counter-{mode}").remote()
    assert rt.get(named.increment.remote(5)) == 5
    again = rt.get_actor(f"counter-{mode}")
    assert rt.get(again.increment.remote()) == 6
    rt.kill(named)
    with pytest.raises(rt.ActorDiedError):
        for _ in range(50):  # the kill lands asynchronously
            rt.get(again.increment.remote(), timeout=10)
            time.sleep(0.1)
    with pytest.raises(ValueError):
        rt.get_actor(f"counter-{mode}")


def test_compiled_dag(mode):
    with InputNode() as inp:
        a = Stage.bind(2)
        dag = MultiOutputNode([a.fwd.bind(inp), Stage.bind(3).fwd.bind(a.fwd.bind(inp))])
    compiled = dag.experimental_compile()
    try:
        for i in range(5):  # reusable: many rounds over the same channels
            assert compiled.execute(i).get(timeout=30) == [2 * i, 6 * i]
        x = np.arange(4, dtype=np.int64)
        np.testing.assert_array_equal(compiled.execute(x).get(timeout=30)[1], 6 * x)
    finally:
        compiled.teardown()


@pytest.mark.parametrize("mode", ["cluster"], indirect=True)  # needs worker processes
def test_gpu_resource_and_worker_kinds(mode):
    assert rt.cluster_resources().get("GPU") == 1.0
    cpu = rt.get(worker_probe.remote(), timeout=60)
    gpu = rt.get(gpu_probe.remote(), timeout=60)
    # A CPU worker: forked from the template, no card, no JAX, nothing of the reference.
    assert cpu["cuda_visible_devices"] == "" and not cpu["cuda_available"]
    assert cpu["template"] == {"torch": True, "cuda_initialized": False,
                               "threads": cpu["template"]["threads"]}
    assert not cpu["jax"] and cpu["reference"] == []
    assert cpu["session_dir"].startswith(os.path.join(SESSION_ROOT, "session_"))
    # The GPU worker: forked from the same template (CUDA untouched there), given the card.
    assert gpu["cuda_visible_devices"] == "0" and gpu["accelerator_worker"] == "1"
    assert gpu["template"] == cpu["template"] and gpu["pid"] != cpu["pid"]
