"""The port's durable workflows (`ray_tpu_torch.workflow`, a copy of the
reference's): the cases of `tests/test_workflow.py` on the port's local
runtime, and one DAG run through both packages with equal outputs and equal
step keys in storage. The default storage root follows TMPDIR, beside the
port's sessions.

One local runtime for the module; each case has its own storage root."""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import workflow
from ray_tpu_torch.workflow import TimerListener, wait_for_event, with_options


@pytest.fixture(scope="module")
def local_rt():
    rt.init(local_mode=True)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.fixture
def wf(tmp_path, local_rt):
    workflow.init(str(tmp_path / "wf_storage"))
    yield
    workflow.init(None)


def _touch_count(path):
    with open(path, "ab") as f:
        f.write(b"x")


def _count(path):
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def test_run_simple_dag(wf):
    @rt.remote
    def add(a, b):
        return a + b

    assert workflow.run(add.bind(add.bind(1, 2), 3), workflow_id="sum3") == 6
    assert workflow.get_status("sum3") == workflow.WorkflowStatus.SUCCESSFUL
    assert workflow.get_output("sum3") == 6
    assert ("sum3", "SUCCESSFUL") in workflow.list_all()
    meta = workflow.get_metadata("sum3")
    assert meta["status"] == "SUCCESSFUL" and "created_at" in meta


def test_rerun_finished_workflow_returns_cached_output(wf, tmp_path):
    marker = str(tmp_path / "ran")

    @rt.remote
    def effect():
        _touch_count(marker)
        return 41

    dag = effect.bind()
    assert workflow.run(dag, workflow_id="once") == 41
    assert workflow.run(dag, workflow_id="once") == 41
    assert _count(marker) == 1


def test_failure_then_resume_skips_completed_steps(wf, tmp_path):
    first_count = str(tmp_path / "first")
    gate = str(tmp_path / "gate")

    @rt.remote
    def first():
        _touch_count(first_count)
        return 10

    @rt.remote
    def second(x):
        if not os.path.exists(gate):
            raise RuntimeError("gate closed")
        return x + 5

    with pytest.raises(Exception, match="gate closed"):
        workflow.run(second.bind(first.bind()), workflow_id="resumable")
    assert workflow.get_status("resumable") == "FAILED"
    assert _count(first_count) == 1
    open(gate, "w").close()
    assert workflow.resume("resumable") == 15
    assert workflow.get_status("resumable") == "SUCCESSFUL"
    assert _count(first_count) == 1


def test_resume_all(wf, tmp_path):
    gate = str(tmp_path / "gate2")

    @rt.remote
    def gated():
        if not os.path.exists(gate):
            raise RuntimeError("closed")
        return "done"

    for wid in ("wf_a", "wf_b"):
        with pytest.raises(Exception):
            workflow.run(gated.bind(), workflow_id=wid)
    open(gate, "w").close()
    assert {wid: fut.result() for wid, fut in workflow.resume_all()} == {"wf_a": "done", "wf_b": "done"}


def test_step_retries(wf, tmp_path):
    attempts = str(tmp_path / "attempts")

    @rt.remote
    def flaky():
        _touch_count(attempts)
        if _count(attempts) < 3:
            raise RuntimeError("boom")
        return "ok"

    assert workflow.run(with_options(flaky.bind(), max_retries=5), workflow_id="retry") == "ok"
    assert _count(attempts) == 3


def test_catch_exceptions_option(wf):
    @rt.remote
    def bad():
        raise ValueError("expected")

    val, err = workflow.run(with_options(bad.bind(), catch_exceptions=True), workflow_id="caught")
    assert val is None and isinstance(err, Exception)
    assert workflow.get_status("caught") == "SUCCESSFUL"


def test_cancel_mid_run(wf, tmp_path):
    step_done = str(tmp_path / "step_done")

    @rt.remote
    def slow(i):
        _touch_count(step_done)
        time.sleep(0.4)
        return i

    fut = workflow.run_async(slow.bind(slow.bind(slow.bind(slow.bind(0)))), workflow_id="cancelme")
    while _count(step_done) == 0:
        time.sleep(0.05)
    workflow.cancel("cancelme")
    with pytest.raises(Exception):
        fut.result(timeout=30)
    assert workflow.get_status("cancelme") == "CANCELED"
    assert _count(step_done) < 4


def test_continuation(wf):
    @rt.remote
    def final(x):
        return x * 2

    @rt.remote
    def start(x):
        return workflow.continuation(final.bind(x + 1))

    assert workflow.run(start.bind(10), workflow_id="cont") == 22


def test_nested_continuation(wf):
    @rt.remote
    def leaf(x):
        return x + 100

    @rt.remote
    def inner():
        return workflow.continuation(leaf.bind(1))

    @rt.remote
    def outer(v):
        return v * 2

    assert workflow.run(outer.bind(inner.bind()), workflow_id="nested") == 202


def test_parallel_branches_overlap(wf):
    @rt.remote
    def slow(i):
        time.sleep(0.5)
        return i

    @rt.remote
    def gather(*xs):
        return sum(xs)

    t0 = time.monotonic()
    assert workflow.run(gather.bind(slow.bind(1), slow.bind(2), slow.bind(3)), workflow_id="par") == 6
    assert time.monotonic() - t0 < 1.3


def test_wait_for_event_timer(wf):
    @rt.remote
    def after(ts):
        return ts > 0

    assert workflow.run(after.bind(wait_for_event(TimerListener, 0.2)), workflow_id="evt") is True


def test_no_checkpoint_option_reexecutes(wf, tmp_path):
    cnt = str(tmp_path / "cnt")
    gate = str(tmp_path / "gate3")

    @rt.remote
    def side():
        _touch_count(cnt)
        return _count(cnt)

    @rt.remote
    def gated(x):
        if not os.path.exists(gate):
            raise RuntimeError("closed")
        return x

    with pytest.raises(Exception):
        workflow.run(gated.bind(with_options(side.bind(), checkpoint=False)), workflow_id="nockpt")
    open(gate, "w").close()
    workflow.resume("nockpt")
    assert _count(cnt) == 2


def test_delete_workflow(wf):
    @rt.remote
    def one():
        return 1

    workflow.run(one.bind(), workflow_id="todelete")
    workflow.delete("todelete")
    assert workflow.get_status("todelete") is None
    assert ("todelete", "SUCCESSFUL") not in workflow.list_all()


# ------------------------------------------------------------ both packages
def _diamond(package, workflow_mod):
    """A diamond with a continuation, an option and a constant argument,
    built from one package's remote functions."""

    @package.remote
    def load(n):
        return list(range(n))

    @package.remote
    def square(xs):
        return [x * x for x in xs]

    @package.remote
    def shift(xs, by):
        return [x + by for x in xs]

    @package.remote
    def total(a, b):
        return sum(a) + sum(b)

    @package.remote
    def double(x):
        return 2 * x

    @package.remote
    def finish(t):
        return workflow_mod.continuation(double.bind(t))

    src = load.bind(6)
    return finish.bind(total.bind(square.bind(src), workflow_mod.with_options(shift.bind(src, 3), max_retries=1)))


def _step_keys(root, workflow_id):
    steps = os.path.join(root, workflow_id, "steps")
    return sorted(os.listdir(steps))


def test_a_dag_through_both_packages(tmp_path, local_rt):
    """The same DAG through the reference's workflow (its local runtime) and
    the port's: equal outputs, equal statuses and equal step keys in storage
    (the continuation's steps included)."""
    import ray_tpu
    from ray_tpu import workflow as ref_workflow

    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    ray_tpu.init(local_mode=True)
    try:
        ref_workflow.init(ref_root)
        want = ref_workflow.run(_diamond(ray_tpu, ref_workflow), workflow_id="diamond")
        want_status = ref_workflow.get_status("diamond")
    finally:
        ref_workflow.init(None)
        ray_tpu.shutdown()
    workflow.init(port_root)
    try:
        got = workflow.run(_diamond(rt, workflow), workflow_id="diamond")
        got_status = workflow.get_status("diamond")
    finally:
        workflow.init(None)
    assert got == want == 2 * (sum(x * x for x in range(6)) + sum(x + 3 for x in range(6)))
    assert got_status == want_status == "SUCCESSFUL"
    keys = _step_keys(port_root, "diamond")
    assert keys == _step_keys(ref_root, "diamond") and len(keys) >= 6


def test_the_default_root_follows_tmpdir(monkeypatch):
    """With no storage given and no RAY_TPU_WORKFLOW_STORAGE, workflows
    live under the port's session root (under TMPDIR), not in a fixed
    directory of /tmp that every checkout shares."""
    from ray_tpu_torch.core.host_names import SESSION_ROOT
    from ray_tpu_torch.workflow import storage

    monkeypatch.delenv("RAY_TPU_WORKFLOW_STORAGE", raising=False)
    assert storage.default_root() == os.path.join(SESSION_ROOT, "workflows")
    monkeypatch.setenv("RAY_TPU_WORKFLOW_STORAGE", "/elsewhere")
    assert storage.default_root() == "/elsewhere"
