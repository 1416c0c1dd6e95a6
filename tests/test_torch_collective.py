"""The port's host-plane collective groups (`ray_tpu_torch.collective`, a
copy of `ray_tpu/collective/__init__.py`: `ray.util.collective`'s API over
the object store) on the port's runtime in local mode: the reference's
local-mode cases of `tests/test_collective.py`, with the reference's
expected values (exact: the values are small integers in f64)."""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import collective


@pytest.fixture(scope="module", autouse=True)
def _rt():
    rt.init(local_mode=True)
    yield
    rt.shutdown()


@rt.remote
class GangMember:
    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def setup(self, group):
        collective.init_collective_group(self.world, self.rank, group_name=group)
        return self.rank

    def do_allreduce(self, group):
        x = np.full((4,), float(self.rank + 1))
        return collective.allreduce(x, group_name=group)

    def do_allgather(self, group):
        return collective.allgather(np.array([self.rank]), group_name=group)

    def do_broadcast(self, group):
        x = np.array([100.0]) if self.rank == 0 else np.zeros(1)
        return collective.broadcast(x, src_rank=0, group_name=group)

    def do_reducescatter(self, group):
        x = np.arange(4.0)
        return collective.reducescatter(x, group_name=group)

    def do_barrier(self, group):
        collective.barrier(group_name=group)
        return "past"

    def do_sendrecv(self, group):
        if self.rank == 0:
            collective.send(np.array([7.0]), dst_rank=1, group_name=group)
            return None
        return collective.recv(src_rank=0, group_name=group)

    def rank_info(self, group):
        return (collective.get_rank(group), collective.get_collective_group_size(group))

    def do_big_allreduce(self, group, n):
        x = np.arange(n, dtype=np.float64) * (self.rank + 1)
        return collective.allreduce(x, group_name=group)

    def do_flat(self, group, n):
        chunk = collective.reduce_scatter_flat(np.arange(n, dtype=np.float64) * (self.rank + 1),
                                               group_name=group)
        return chunk, collective.all_gather_flat(chunk, group_name=group)


def _gang(world, group):
    members = [GangMember.remote(r, world) for r in range(world)]
    rt.get([m.setup.remote(group) for m in members])
    return members


def test_allreduce():
    members = _gang(2, "g_ar")
    for out in rt.get([m.do_allreduce.remote("g_ar") for m in members]):
        np.testing.assert_allclose(out, np.full((4,), 3.0))  # 1 + 2


def test_allgather():
    members = _gang(2, "g_ag")
    for out in rt.get([m.do_allgather.remote("g_ag") for m in members]):
        assert [int(v[0]) for v in out] == [0, 1]


def test_broadcast():
    members = _gang(2, "g_bc")
    for out in rt.get([m.do_broadcast.remote("g_bc") for m in members]):
        np.testing.assert_allclose(out, [100.0])


def test_reducescatter():
    members = _gang(2, "g_rs")
    outs = rt.get([m.do_reducescatter.remote("g_rs") for m in members])
    np.testing.assert_allclose(outs[0], [0.0, 2.0])
    np.testing.assert_allclose(outs[1], [4.0, 6.0])


def test_barrier_and_rank():
    members = _gang(2, "g_b")
    assert rt.get([m.do_barrier.remote("g_b") for m in members]) == ["past", "past"]
    assert rt.get([m.rank_info.remote("g_b") for m in members]) == [(0, 2), (1, 2)]


def test_send_recv():
    members = _gang(2, "g_sr")
    outs = rt.get([m.do_sendrecv.remote("g_sr") for m in members])
    np.testing.assert_allclose(outs[1], [7.0])


def test_allreduce_rs_ag_path():
    """world>=5 + big tensor takes the reduce-scatter/allgather route."""
    world, group = 5, "rsag"
    members = _gang(world, group)
    outs = rt.get([m.do_big_allreduce.remote(group, 5000) for m in members])
    expected = np.arange(5000, dtype=np.float64) * sum(r + 1 for r in range(world))
    for o in outs:
        np.testing.assert_allclose(o, expected)


def test_flat_zero_chunks_follow_zero_shard_bounds():
    """reduce_scatter_flat / all_gather_flat chunk a vector as
    `collective.ops.zero_shard_bounds` says, for a length no world divides."""
    from ray_tpu_torch.collective.ops import zero_shard_bounds

    world, group, n = 3, "flat", 10
    members = _gang(world, group)
    total = np.arange(n, dtype=np.float64) * sum(r + 1 for r in range(world))
    for rank, (chunk, whole) in enumerate(rt.get([m.do_flat.remote(group, n) for m in members])):
        start, end = zero_shard_bounds(n, world, rank)
        np.testing.assert_allclose(chunk, total[start:end])
        np.testing.assert_allclose(whole, total)


def test_declarative_create_collective_group():
    """Driver assigns ranks; members auto-join on first collective call."""
    world, group = 3, "declarative"

    @rt.remote
    class Passive:
        def reduce_something(self, group):
            return collective.allreduce(np.full((8,), 2.0), group_name=group)

        def my_rank(self, group):
            return collective.get_rank(group)

    members = [Passive.remote() for _ in range(world)]
    collective.create_collective_group(members, world, list(range(world)), group_name=group)
    for o in rt.get([m.reduce_something.remote(group) for m in members]):
        np.testing.assert_allclose(o, np.full((8,), 6.0))
    assert sorted(rt.get([m.my_rank.remote(group) for m in members])) == [0, 1, 2]


def test_in_program_collectives_refuse_the_host_plane():
    """Outside shard_fn the in-program collectives have no mesh to name."""
    import torch

    with pytest.raises(RuntimeError, match="no mesh is bound"):
        collective.psum(torch.ones(2), "dp")
