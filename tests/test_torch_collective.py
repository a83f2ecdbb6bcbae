"""ray_tpu_torch.util.collective on gloo, held against the JAX package's
XLA group on the CPU.

Every case of ``tests/test_collective.py`` runs twice on the same numpy
inputs: on the port's ``TorchGroup`` (gloo, one rank per actor of the
port's cluster) and on ray_tpu's ``XLAGroup`` (one rank per actor of
ray_tpu's cluster, jax.distributed on the CPU). The two results must be
equal, and equal to the values ``test_collective.py`` expects. The
subset cases run in a world of 6 in both. Every wait has its own
deadline.
"""

import importlib

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt

TIMEOUT = 120


class Member:
    """One rank, in either package: ``package`` names whose collective
    API it calls (``ray_tpu`` on the xla backend, ``ray_tpu_torch`` on
    gloo)."""

    def __init__(self, package):
        self.col = importlib.import_module(package + ".util.collective")
        self.ops = importlib.import_module(
            package + ".util.collective.types").ReduceOp
        self.backend = "xla" if package == "ray_tpu" else "gloo"
        self.rank = None

    def setup(self, world_size, rank, group_name):
        self.col.init_collective_group(world_size, rank, self.backend,
                                       group_name)
        self.rank = rank
        return self.col.get_rank(group_name)

    def allreduce(self, value, group_name, op=None, dtype="float32"):
        t = np.full((4,), value, dtype=dtype)
        if op is None:
            return self.col.allreduce(t, group_name)
        return self.col.allreduce(t, group_name, self.ops[op])

    def allgather(self, value, group_name):
        return self.col.allgather(
            np.full((2,), value, dtype=np.float32), group_name)

    def reducescatter(self, base, group_name, op=None):
        t = np.arange(4, dtype=np.float32) + base
        if op is None:
            return self.col.reducescatter(t, group_name)
        return self.col.reducescatter(t, group_name, self.ops[op])

    def reduce(self, value, dst, group_name):
        return self.col.reduce(np.full((3,), value, dtype=np.float32), dst,
                               group_name)

    def broadcast(self, value, src, group_name):
        return self.col.broadcast(
            np.full((3,), value, dtype=np.float32), src, group_name)

    def barrier_then_rank(self, group_name):
        self.col.barrier(group_name)
        return self.rank

    def sendrecv(self, group_name):
        # rank 0 sends, rank 1 receives.
        if self.rank == 0:
            self.col.send(np.array([42.0], dtype=np.float32), 1, group_name)
            return None
        return self.col.recv(((1,), np.float32), 0, group_name)

    def group_info(self, group_name):
        return (self.col.get_rank(group_name),
                self.col.get_collective_group_size(group_name),
                self.col.is_group_initialized(group_name))

    def solo(self, group_name):
        self.col.init_collective_group(1, 0, self.backend, group_name)
        a = self.col.allreduce(np.ones(3, dtype=np.float32), group_name)
        g = self.col.allgather(np.ones(2, dtype=np.float32), group_name)
        return a, g

    def torch_allreduce(self, group_name):
        import torch

        t = torch.full((2,), float(self.rank + 1))
        out = self.col.allreduce(t, group_name)
        return type(out).__name__, out.numpy(), t.numpy()

    def recreate(self, world_size, rank, group_name, value):
        self.col.destroy_collective_group(group_name)
        self.col.init_collective_group(world_size, rank, self.backend,
                                       group_name)
        return self.col.allreduce(np.full((2,), value, np.float32),
                                  group_name)


JaxMember = ray_tpu.remote(Member)
TorchMember = rt.remote(Member)


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


def _gang(n, group_name):
    """n ranks in each package, each set up in ``group_name``: a dict of
    package -> (get, actors)."""
    gangs = {"ray_tpu": (ray_tpu.get, [JaxMember.remote("ray_tpu")
                                       for _ in range(n)]),
             "ray_tpu_torch": (rt.get, [TorchMember.remote("ray_tpu_torch")
                                        for _ in range(n)])}
    for get, actors in gangs.values():
        ranks = get([a.setup.remote(n, i, group_name)
                     for i, a in enumerate(actors)], timeout=TIMEOUT)
        assert ranks == list(range(n))
    return gangs


def both(gangs, call):
    """``call(rank, actor)`` -> a ref, on every rank of both packages:
    (torch results, xla results), each in rank order."""
    out = {}
    for pkg, (get, actors) in gangs.items():
        out[pkg] = get([call(i, a) for i, a in enumerate(actors)],
                       timeout=TIMEOUT)
    return out["ray_tpu_torch"], out["ray_tpu"]


def assert_same(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if b is None:
            assert a is None
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def group2(clusters):
    return _gang(2, "tg")


class TestAgainstXLAGroup:
    @pytest.mark.parametrize("op,want", [(None, 3.0), ("MAX", 2.0),
                                         ("MIN", 1.0), ("PRODUCT", 2.0)])
    def test_allreduce(self, group2, op, want):
        ours, theirs = both(group2, lambda i, a: a.allreduce.remote(
            float(i + 1), "tg", op))
        assert_same(ours, theirs)
        for o in ours:
            np.testing.assert_allclose(o, np.full((4,), want))

    def test_allreduce_int32(self, group2):
        ours, theirs = both(group2, lambda i, a: a.allreduce.remote(
            i + 5, "tg", None, "int32"))
        assert_same(ours, theirs)
        np.testing.assert_array_equal(ours[0], np.full((4,), 11, np.int32))

    def test_allgather(self, group2):
        ours, theirs = both(group2, lambda i, a: a.allgather.remote(
            float(i * 10), "tg"))
        assert_same(ours, theirs)
        for o in ours:
            np.testing.assert_allclose(o, [[0.0, 0.0], [10.0, 10.0]])

    @pytest.mark.parametrize("op,want", [(None, [[1.0, 3.0], [5.0, 7.0]]),
                                         ("MAX", [[1.0, 2.0], [3.0, 4.0]])])
    def test_reducescatter(self, group2, op, want):
        ours, theirs = both(group2, lambda i, a: a.reducescatter.remote(
            float(i), "tg", op))
        assert_same(ours, theirs)
        # sum = [1,3,5,7]; rank0 chunk [1,3], rank1 [5,7]
        np.testing.assert_allclose(ours[0], want[0])
        np.testing.assert_allclose(ours[1], want[1])

    @pytest.mark.parametrize("dst", [0, 1])
    def test_reduce(self, group2, dst):
        ours, theirs = both(group2, lambda i, a: a.reduce.remote(
            float(i + 2), dst, "tg"))
        assert_same(ours, theirs)
        np.testing.assert_allclose(ours[dst], np.full((3,), 5.0))
        np.testing.assert_allclose(ours[1 - dst],
                                   np.full((3,), float(1 - dst + 2)))

    def test_broadcast(self, group2):
        ours, theirs = both(group2, lambda i, a: a.broadcast.remote(
            float(i + 5), 1, "tg"))
        assert_same(ours, theirs)
        for o in ours:
            np.testing.assert_allclose(o, np.full((3,), 6.0))

    def test_barrier(self, group2):
        ours, theirs = both(group2, lambda i, a: a.barrier_then_rank.remote(
            "tg"))
        assert ours == theirs == [0, 1]

    def test_send_recv(self, group2):
        ours, theirs = both(group2, lambda i, a: a.sendrecv.remote("tg"))
        assert_same(ours, theirs)
        assert ours[0] is None
        np.testing.assert_allclose(ours[1], [42.0])

    def test_group_info(self, group2):
        ours, theirs = both(group2, lambda i, a: a.group_info.remote("tg"))
        assert ours == theirs == [(0, 2, True), (1, 2, True)]

    def test_torch_tensors_stay_tensors(self, group2):
        _, actors = group2["ray_tpu_torch"]
        got = rt.get([a.torch_allreduce.remote("tg") for a in actors],
                     timeout=TIMEOUT)
        for kind, out, given in got:
            assert kind == "Tensor"
            np.testing.assert_array_equal(out, [3.0, 3.0])
        # The inputs are left as they were.
        assert [list(g) for _, _, g in got] == [[1.0, 1.0], [2.0, 2.0]]


class TestLocalGroup:
    def test_world_size_one(self, clusters):
        ours = rt.get(TorchMember.remote("ray_tpu_torch").solo.remote("solo"),
                      timeout=TIMEOUT)
        theirs = ray_tpu.get(JaxMember.remote("ray_tpu").solo.remote("solo"),
                             timeout=TIMEOUT)
        assert_same(ours, theirs)
        np.testing.assert_allclose(ours[0], np.ones(3))
        assert ours[1].shape == (1, 2)

    def test_validation(self, clusters):
        from ray_tpu_torch.util import collective as col

        with pytest.raises(ValueError):
            col.init_collective_group(0, 0)
        with pytest.raises(ValueError):
            col.init_collective_group(2, 5)

    @pytest.mark.parametrize("name", ["xla", "tpu", "mpi"])
    def test_other_backends_raise(self, name):
        from ray_tpu_torch.util import collective as col

        with pytest.raises(ValueError, match="nccl.*gloo"):
            col.Backend(name)

    def test_nccl_without_a_card_raises(self, clusters):
        import torch

        from ray_tpu_torch.util import collective as col

        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            col.init_collective_group(1, 0, "nccl", "no_card")
        assert not col.is_group_initialized("no_card")

    def test_declarative_metadata(self, clusters):
        from ray_tpu_torch.util import collective as col

        actors = [TorchMember.remote("ray_tpu_torch") for _ in range(2)]
        info = col.create_collective_group(actors, 2, [0, 1], "gloo",
                                           "decl")
        assert info["world_size"] == 2 and info["backend"] == "gloo"
        stored = col.get_group_info("decl")
        assert stored["world_size"] == 2
        assert len(stored["ranks"]) == 2

    def test_destroyed_group_name_is_reusable(self, group2):
        _, actors = group2["ray_tpu_torch"]
        rt.get([a.setup.remote(2, i, "again") for i, a in enumerate(actors)],
               timeout=TIMEOUT)
        out = rt.get([a.recreate.remote(2, i, "again", float(i + 1))
                      for i, a in enumerate(actors)], timeout=TIMEOUT)
        for o in out:
            np.testing.assert_allclose(o, [3.0, 3.0])


class TestSubsetGroups:
    """Groups over overlapping and disjoint subsets of a world of 6, each
    with a process group of its own (reference: GroupManager with per-
    process group registry, collective.py:40,120-151)."""

    @pytest.fixture(scope="class")
    def world6(self, clusters):
        return _gang(6, "g6")

    def _join(self, world6, members, name):
        for get, actors in world6.values():
            get([actors[g].setup.remote(len(members), i, name)
                 for i, g in enumerate(members)], timeout=TIMEOUT)

    def _on(self, world6, members, call):
        out = {}
        for pkg, (get, actors) in world6.items():
            out[pkg] = get([call(i, actors[g])
                            for i, g in enumerate(members)], timeout=TIMEOUT)
        return out["ray_tpu_torch"], out["ray_tpu"]

    def test_overlapping_subset_allreduces(self, world6):
        a_members, b_members = [0, 1, 2, 3], [2, 3, 4, 5]
        self._join(world6, a_members, "sub_a")
        self._join(world6, b_members, "sub_b")
        ours, theirs = self._on(world6, a_members, lambda i, a:
                                a.allreduce.remote(float(i + 1), "sub_a"))
        assert_same(ours, theirs)
        for o in ours:
            np.testing.assert_allclose(o, np.full((4,), 10.0))
        ours, theirs = self._on(world6, b_members, lambda i, a:
                                a.allreduce.remote(float((i + 1) * 10),
                                                   "sub_b"))
        assert_same(ours, theirs)
        for o in ours:
            np.testing.assert_allclose(o, np.full((4,), 100.0))

    def test_subset_broadcast_and_rank_info(self, world6):
        c_members = [1, 4]
        self._join(world6, c_members, "sub_c")
        ours, theirs = self._on(world6, c_members, lambda i, a:
                                a.broadcast.remote(float(7 + i), 0, "sub_c"))
        assert_same(ours, theirs)
        for o in ours:
            np.testing.assert_allclose(o, np.full((3,), 7.0))
        ours, theirs = self._on(world6, c_members, lambda i, a:
                                a.group_info.remote("sub_c"))
        assert ours == theirs == [(0, 2, True), (1, 2, True)]

    def test_disjoint_tp_groups_inside_dp_world(self, world6):
        groups = [[0, 1], [2, 3], [4, 5]]
        for gi, members in enumerate(groups):
            self._join(world6, members, f"tp_{gi}")
        for gi, members in enumerate(groups):
            base = float((gi + 1) * 100)
            ours, theirs = self._on(world6, members, lambda i, a:
                                    a.allreduce.remote(base + i, f"tp_{gi}"))
            assert_same(ours, theirs)
            for o in ours:
                np.testing.assert_allclose(o, np.full((4,), 2 * base + 1.0))
