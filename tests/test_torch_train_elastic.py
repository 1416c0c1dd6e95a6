"""The port's elastic training layer (`ray_tpu_torch.train.elastic`), after
`tests/test_train_elastic.py`: the sharded checkpoint plane (save, group
commit, restore, reshard on a world change, incarnations, retention, the
lens sidecars), with f32 and bf16 torch tensors (AdamW's first moment is
bf16, which numpy cannot hold: every dtype must round-trip exactly); the
async save's overlap and a SIGKILL during a save; the supervisor policy; a
local-mode gang restart that resumes deterministically; and, in cluster
mode, the controller's death feed and a SIGKILLed gang worker whose mesh
aborts and resumes from the last commit with the unkilled trajectory.

A loop runs in the gang's workers, which cannot import this module: each
is a closure made by a factory, so cloudpickle ships it by value."""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.train import DataParallelTrainer, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.elastic import COMMIT_MARKER, AsyncShardWriter, ElasticState, GangSupervisor, \
    ShardedCheckpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def local_runtime():
    rt.init(local_mode=True)
    yield
    rt.shutdown()


def _arange(n, dtype=torch.float32, start=0.0):
    return (torch.arange(n, dtype=torch.float32) + start).to(dtype)


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------ checkpoint plane
class TestShardedCheckpoint:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_save_commit_restore_roundtrip(self, tmp_path, dtype):
        root = str(tmp_path)
        w0, w1 = (AsyncShardWriter(root, r, 2, gen="g1") for r in range(2))
        st = ElasticState(step=3, data_offsets={"train": 6})
        w0.save(3, {"x": _arange(4, dtype)}, st)
        w1.save(3, {"x": _arange(4, dtype, 10)}, st)
        assert w0.flush() and w1.flush()
        step, ckpt_dir = ShardedCheckpoint.latest_committed(root)
        assert step == 3 and os.path.exists(os.path.join(ckpt_dir, COMMIT_MARKER))
        state, tree = ShardedCheckpoint.restore(root, 1, 2)
        assert state.step == 3 and state.data_offsets["train"] == 6
        assert _equal(tree["x"], _arange(4, dtype, 10))
        w0.close()
        w1.close()

    def test_uncommitted_dir_is_skipped(self, tmp_path):
        root = str(tmp_path)
        w0, w1 = (AsyncShardWriter(root, r, 2, gen="g1") for r in range(2))
        w0.save(1, {"x": torch.ones(2)}, ElasticState(step=1))
        w1.save(1, {"x": torch.ones(2)}, ElasticState(step=1))
        assert w0.flush() and w1.flush()
        # Step 2: only one rank's shard lands, so step 1 stays restorable.
        w0.save(2, {"x": torch.ones(2) * 2}, ElasticState(step=2))
        w0.flush()
        assert ShardedCheckpoint.latest_committed(root)[0] == 1
        assert ShardedCheckpoint.restore(root, 0, 2)[0].step == 1
        w0.close()
        w1.close()

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_restore_reshards_on_world_change(self, tmp_path, dtype):
        root = str(tmp_path)
        writers = [AsyncShardWriter(root, r, 2, gen="a") for r in range(2)]
        shards = [_arange(4, dtype), _arange(4, dtype, 10)]
        for r, w in enumerate(writers):
            w.save(1, {"x": shards[r], "lr": 0.1, "step": torch.tensor(5)}, ElasticState(step=1))
        assert all(w.flush() for w in writers)
        # 2 -> 4: each new rank gets a quarter of the concatenation.
        _, t = ShardedCheckpoint.restore(root, 3, 4)
        assert _equal(t["x"], torch.tensor([12.0, 13.0]).to(dtype))
        assert t["lr"] == 0.1 and int(t["step"]) == 5  # non-tensor and 0-d leaves are replicated
        # 2 -> 1: the full concatenation.
        _, t = ShardedCheckpoint.restore(root, 0, 1)
        assert _equal(t["x"], torch.cat(shards))
        # 2 -> 9: more ranks than rows, the last rank's slice is empty.
        _, t = ShardedCheckpoint.restore(root, 8, 9)
        assert t["x"].shape == (0,) and t["x"].dtype == dtype
        for w in writers:
            w.close()

    def test_incarnations_never_mix(self, tmp_path):
        root = str(tmp_path)
        wa = AsyncShardWriter(root, 0, 2, gen="aa")
        wa.save(2, {"x": torch.zeros(2)}, ElasticState(step=2))
        wa.flush()
        wb = AsyncShardWriter(root, 1, 2, gen="bb")
        wb.save(2, {"x": torch.ones(2)}, ElasticState(step=2))
        wb.flush()
        assert ShardedCheckpoint.latest_committed(root) is None
        wa.close()
        wb.close()

    def test_retention_prunes_old_checkpoints(self, tmp_path):
        root = str(tmp_path)
        stale = os.path.join(root, "step_00000001.dead")
        os.makedirs(stale)
        open(os.path.join(stale, "shard_00000.pkl"), "wb").close()
        w = AsyncShardWriter(root, 0, 1, gen="g", keep=2)
        for step in (2, 3, 4, 5):
            w.save(step, {"x": torch.full((2,), float(step))}, ElasticState(step=step))
            assert w.flush()
        assert [s for s, _ in ShardedCheckpoint.list_checkpoints(root)] == [4, 5]
        assert ShardedCheckpoint.latest_committed(root)[0] == 5
        w.close()

    def test_reshard_uses_lens_sidecars_not_full_shards(self, tmp_path, monkeypatch):
        """Pass 1 of a world-size-changed restore reads the lens sidecars,
        which hold the leading lengths of the bf16 and f32 tensors; removing
        them falls back to unpickling the shards, with the same result."""
        import json

        root = str(tmp_path)
        writers = [AsyncShardWriter(root, r, 4, gen="a") for r in range(4)]
        for r, w in enumerate(writers):
            w.save(1, {"x": _arange(2, torch.float32, 2 * r), "mu": _arange(2, torch.bfloat16, 2 * r),
                       "n": torch.tensor(1)}, ElasticState(step=1))
        assert all(w.flush() for w in writers)
        for w in writers:
            w.close()
        _, ckpt_dir = ShardedCheckpoint.latest_committed(root)
        with open(os.path.join(ckpt_dir, "shard_00003.lens.json")) as f:
            assert sorted(json.load(f), key=str) == [2, 2, None]

        loads = []
        real = ShardedCheckpoint.load_shard

        def counting(ckpt_dir, rank):
            loads.append(rank)
            return real(ckpt_dir, rank)

        monkeypatch.setattr(ShardedCheckpoint, "load_shard", counting)
        # Rank 1 of 2 owns rows 4..7 = shards 2 and 3.
        _, t = ShardedCheckpoint.restore(root, 1, 2)
        assert _equal(t["x"], _arange(4, torch.float32, 4)) and _equal(t["mu"], _arange(4, torch.bfloat16, 4))
        assert sorted(set(loads)) == [0, 2, 3], loads

        loads.clear()
        for r in range(4):
            os.remove(os.path.join(ckpt_dir, f"shard_{r:05d}.lens.json"))
        _, t = ShardedCheckpoint.restore(root, 1, 2)
        assert _equal(t["mu"], _arange(4, torch.bfloat16, 4))
        assert sorted(set(loads)) == [0, 1, 2, 3], loads

    def test_data_offsets_are_world_size_independent(self):
        st = ElasticState(step=1, data_offsets={"train": 7})
        assert [st.local_offset("train", r, 3) for r in range(3)] == [9, 7, 8]
        assert [st.local_offset("train", r, 2) for r in range(2)] == [8, 7]


def test_save_snapshots_the_tensors(tmp_path):
    """The writer owns its bytes: a tensor changed in place after save()
    returns is saved as it was."""
    w = AsyncShardWriter(str(tmp_path), 0, 1, gen="g")
    x = torch.zeros(4, dtype=torch.bfloat16)
    w.save(1, {"x": x}, ElasticState(step=1))
    x.add_(1)
    assert w.flush()
    assert _equal(ShardedCheckpoint.restore(str(tmp_path), 0, 1)[1]["x"], torch.zeros(4, dtype=torch.bfloat16))
    w.close()


def test_async_save_does_not_block_step(tmp_path, monkeypatch):
    from ray_tpu_torch.train.elastic import ckpt as ckpt_mod

    real_write = ckpt_mod._write_atomic
    write_s = 0.4

    def slow_write(path, data, tmp=None):
        time.sleep(write_s)
        real_write(path, data, tmp=tmp)

    monkeypatch.setattr(ckpt_mod, "_write_atomic", slow_write)
    w = AsyncShardWriter(str(tmp_path), 0, 1, gen="g")
    t0 = time.monotonic()
    w.save(1, {"x": torch.zeros(1 << 16)}, ElasticState(step=1))
    blocked = time.monotonic() - t0
    assert blocked < write_s / 2, f"save() blocked {blocked:.3f}s on the write"
    assert w.flush(timeout=30.0)
    assert w.last_write_s >= write_s
    assert ShardedCheckpoint.latest_committed(str(tmp_path))[0] == 1
    w.close()


def test_kill_during_async_save_preserves_previous_commit(tmp_path):
    root = str(tmp_path)
    child_src = f"""
import os, sys, time
sys.path.insert(0, {REPO!r})
import torch
from ray_tpu_torch.train.elastic import AsyncShardWriter, ElasticState
from ray_tpu_torch.train.elastic import ckpt as ckpt_mod

root = sys.argv[1]
w = AsyncShardWriter(root, 0, 1, gen="a")
w.save(1, {{"x": torch.arange(8.0).bfloat16()}}, ElasticState(step=1))
assert w.flush()

def half_then_hang(path, data):
    with open(path + ".tmp", "wb") as f:
        f.write(data[: len(data) // 2])
        f.flush(); os.fsync(f.fileno())
    print("MIDWRITE", flush=True)
    time.sleep(120)
ckpt_mod._write_atomic = half_then_hang
w2 = AsyncShardWriter(root, 0, 1, gen="b")
w2.save(2, {{"x": torch.arange(8.0).bfloat16() + 1}}, ElasticState(step=2))
time.sleep(120)
"""
    proc = subprocess.Popen([sys.executable, "-c", child_src, root], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        saw_midwrite = False
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if "MIDWRITE" in line:
                saw_midwrite = True
                break
        assert saw_midwrite, "child never reached the mid-write point"
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    step, _ = ShardedCheckpoint.latest_committed(root)
    assert step == 1, "the partial step-2 save must not be visible"
    state, tree = ShardedCheckpoint.restore(root, 0, 1)
    assert state.step == 1 and _equal(tree["x"], torch.arange(8.0).bfloat16())


# ------------------------------------------------------------ supervisor
class TestSupervisorPolicy:
    def test_budget_and_backoff(self):
        sup = GangSupervisor(ScalingConfig(num_workers=4),
                             FailureConfig(max_failures=3, backoff_base_s=0.5, backoff_max_s=2.0))
        backoffs = []
        for _ in range(3):
            d = sup.on_failure("boom")
            assert not d.stop
            backoffs.append(d.backoff_s)
        assert backoffs == [0.5, 1.0, 2.0]
        assert sup.plan_world_size() == 4
        assert sup.on_failure("boom").stop

    def test_budget_zero_keeps_legacy_fail_fast(self):
        assert GangSupervisor(ScalingConfig(num_workers=2), FailureConfig()).on_failure("boom").stop

    def test_elasticity_band(self):
        s = ScalingConfig(num_workers=4, min_workers=2, max_workers=4)
        assert [s.pick_world_size(f) for f in (None, 3, 1, 9)] == [4, 3, 2, 4]
        assert ScalingConfig(num_workers=4).pick_world_size(1) == 4


# ------------------------------------------------------------ gang restarts
def _deterministic_loop_factory():
    def loop(config):
        """x += (step+1)*0.5 each step (a bf16 and an f32 copy); rank 0
        dies once at fail_at in its first incarnation."""
        import os

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.train import elastic

        ctx = train.get_context()
        sess = elastic.elastic_session()
        tree = sess.restore()
        x = tree["x"] if tree is not None else torch.zeros(4)
        xb = tree["xb"] if tree is not None else torch.zeros(4, dtype=torch.bfloat16)
        for step in range(sess.state.step, config["total_steps"]):
            fail_at = config.get("fail_at")
            if fail_at is not None and ctx.get_world_rank() == 0 and step == fail_at \
                    and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected gang failure")
            x = x + (step + 1) * 0.5
            xb = xb + (step + 1) * 0.5
            train.report({"step": step, "x0": float(x[0]), "xb0": float(xb[0]), "rank": ctx.get_world_rank()})
            sess.save(step + 1, {"x": x, "xb": xb}, data_offsets={"train": (step + 1) * ctx.get_world_size()})
        sess.flush()

    return loop


def _per_step(history, key="x0"):
    return {int(m["step"]): m[key] for m in history}


def test_gang_restart_resumes_deterministically(tmp_path, local_runtime):
    total = 6
    kill_cfg = {"total_steps": total, "fail_at": 3, "marker": str(tmp_path / "died_once")}
    killed = DataParallelTrainer(
        _deterministic_loop_factory(), train_loop_config=kill_cfg, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path / "killed"),
                             failure_config=FailureConfig(max_failures=1, backoff_base_s=0.01)),
    ).fit()
    assert killed.error is None, killed.error
    assert os.path.exists(kill_cfg["marker"]), "failure was never injected"
    clean = DataParallelTrainer(
        _deterministic_loop_factory(), train_loop_config={"total_steps": total},
        scaling_config=ScalingConfig(num_workers=2), run_config=RunConfig(storage_path=str(tmp_path / "clean")),
    ).fit()
    assert clean.error is None, clean.error
    for key in ("x0", "xb0"):
        got, want = _per_step(killed.metrics_history, key), _per_step(clean.metrics_history, key)
        assert sorted(got) == list(range(total)), "step counter not continuous"
        assert got == want, key  # exactly: the bf16 state came back bit for bit
    ns_parent = os.path.join(str(tmp_path / "killed"), "run", "elastic")
    (run_ns,) = os.listdir(ns_parent)
    state, tree = ShardedCheckpoint.restore(os.path.join(ns_parent, run_ns), 0, 2)
    assert state.step == total and state.data_offsets["train"] == total * 2
    assert tree["xb"].dtype == torch.bfloat16


def _kwargs_conflict_loop():
    def loop(config):
        from ray_tpu_torch.train import elastic

        sess = elastic.elastic_session()
        assert elastic.elastic_session(mode="replicated") is sess
        try:
            elastic.elastic_session(mode="sharded")
        except RuntimeError as e:
            assert "conflicts" in str(e)
        else:
            raise AssertionError("conflicting kwargs silently accepted")

    return loop


def test_elastic_session_kwargs_conflict_is_loud(tmp_path, local_runtime):
    result = DataParallelTrainer(_kwargs_conflict_loop(), scaling_config=ScalingConfig(num_workers=1),
                                 run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error


# ------------------------------------------------------------ cluster mode
def test_poll_events_reports_gang_member_death():
    from ray_tpu_torch.core import api

    rt.init(num_cpus=2)
    try:
        backend = api._global_runtime().backend
        cursor = backend.poll_events(cursor=-1)["cursor"]

        @rt.remote
        class Member:
            def ping(self):
                return True

        a = Member.remote()
        rt.get(a.ping.remote())
        workers = backend._request({"type": "list_workers"})["workers"]
        wid = next(w["worker_id"] for w in workers if w.get("actor") == a._id.hex())
        backend._request({"type": "kill_worker", "worker_id": wid})
        seen = False
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not seen:
            resp = backend.poll_events(cursor=cursor, kinds=("actor_death", "chaos_worker_killed"))
            cursor = resp["cursor"]
            seen = any(ev.get("event") == "actor_death" and ev.get("actor") == a._id.hex()
                       for ev in resp["events"])
            time.sleep(0.05)
        assert seen, "death event never reached the feed"
    finally:
        rt.shutdown()


def _gang_loop_factory():
    def loop(config):
        import time

        import torch

        from ray_tpu_torch import collective, train
        from ray_tpu_torch.train import elastic

        ctx = train.get_context()
        sess = elastic.elastic_session()
        tree = sess.restore()
        x = tree["x"] if tree is not None else torch.zeros(2)
        for step in range(sess.state.step, config["total_steps"]):
            # Cross-worker coupling every step: a dead peer leaves the
            # survivor blocked here, the wedge the supervisor must break.
            g = collective.allreduce(torch.full((2,), float(step + 1)).numpy(),
                                     group_name=config["collective_group"])
            x = x + 0.1 * torch.as_tensor(g)
            train.report({"step": step, "x0": float(x[0]), "rank": ctx.get_world_rank()})
            sess.save(step + 1, {"x": x})
            time.sleep(config.get("step_sleep", 0.0))
        sess.flush()

    return loop


def test_sigkill_gang_worker_mesh_aborts_and_resumes(tmp_path):
    """SIGKILL one gang worker mid-run: the whole mesh aborts within the
    supervisor's deadline, the gang restarts, and training resumes from the
    last committed checkpoint with a continuous step counter and the
    unkilled trajectory."""
    from ray_tpu_torch.core import api
    from ray_tpu_torch.train.backend_executor import BackendExecutor
    from ray_tpu_torch.train.data_parallel_trainer import CollectiveBackend

    total = 14
    rt.init(num_cpus=4)
    try:
        backend = CollectiveBackend()
        run_cfg = RunConfig(storage_path=str(tmp_path / "killed"),
                            failure_config=FailureConfig(max_failures=2, backoff_base_s=0.05))
        ex = BackendExecutor(backend, ScalingConfig(num_workers=2), run_cfg, experiment_name="chaos")
        ex.start()
        victim_hex = ex.worker_group.actor_ids()[1]
        elastic_root = os.path.join(run_cfg.resolve_storage(), "elastic", ex.elastic_run_ns)
        killed = {}

        def killer():
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                found = ShardedCheckpoint.latest_committed(elastic_root)
                if found is not None and found[0] >= 2:
                    break
                time.sleep(0.02)
            workers = api._global_runtime().backend._request({"type": "list_workers"})["workers"]
            pid = next((w.get("pid") for w in workers if w.get("actor") == victim_hex), 0)
            if pid:
                os.kill(pid, signal.SIGKILL)
                killed["t"], killed["pid"] = time.monotonic(), pid

        th = threading.Thread(target=killer, daemon=True)
        th.start()
        result = ex.run(_gang_loop_factory(),
                        {"collective_group": backend.group_name, "total_steps": total, "step_sleep": 0.05})
        t_done = time.monotonic()
        sup = ex._supervisor
        ex.shutdown()
        assert killed.get("pid"), "killer thread never fired"
        assert result.error is None, result.error
        assert sup.attempts >= 1, "the gang never restarted"
        assert sup.last_recovery_s is not None and sup.last_recovery_s < 60
        assert t_done - killed["t"] < 90
        got = _per_step(result.metrics_history)
        assert sorted(got) == list(range(total)), "step counter not continuous"
        for s in range(total):
            assert got[s] == pytest.approx(0.2 * sum(i + 1 for i in range(s + 1))), f"diverged at step {s}"
    finally:
        rt.shutdown()
