"""The port's ecosystem shims held against ``ray_tpu``'s: every case of
``tests/test_ecosystem.py`` in both packages (``Pool``, the joblib
backend, ``ParallelIterator``, ``ActorGroup``, the dask scheduler, the
gated GBDT trainers, the xgboost and spark stubs), the
``experimental.collective`` allreduce in a compiled DAG (a bf16 tensor
on the port's side, numpy on ray_tpu's, the same values),
``broadcast_object`` over daemon nodes, and ``Pool`` actors pinned to
GPUs (faked with ``RTT_NUM_GPUS=2``).

Both packages' clusters are alive in this module; the functions the
workers run are plain functions of this module, which imports neither
package at module level (the workers import it by name).
"""

import importlib
import os
from operator import add, mul

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
TIMEOUT = 60


def _pkg(package, sub=""):
    return importlib.import_module(package + (f".{sub}" if sub else ""))


def _both(case):
    out = {package: case(package) for package in PACKAGES}
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu"]


# -- broadcast_object over daemon nodes (before the module's clusters) ------

def test_broadcast_object_over_daemon_nodes():
    """test_adoption.py's broadcast on 2 daemon nodes of each package:
    every node holds a copy, and a task on each reads it."""
    def case(package):
        pkg = _pkg(package)
        if pkg.is_initialized():
            pkg.shutdown()
        cluster = _pkg(package, "cluster_utils").Cluster(
            initialize_head=True, head_node_args={"num_cpus": 1})
        try:
            for i in range(2):
                cluster.add_node(num_cpus=1, resources={f"n{i}": 1},
                                 daemon=True)
            payload = np.random.default_rng(0).integers(
                0, 255, size=4 << 20, dtype=np.uint8)
            ref = pkg.put(payload)
            copies = _pkg(package, "experimental").broadcast_object(ref)

            def node_sum(a):  # by value: a daemon's workers cannot
                return int(a.sum())  # import this module

            check = pkg.remote(node_sum)
            sums = pkg.get([check.options(resources={f"n{i}": 1}).remote(ref)
                            for i in range(2)], timeout=TIMEOUT)
            return copies, sums == [int(payload.sum())] * 2
        finally:
            cluster.shutdown()

    assert _both(case) == (3, True)


@pytest.fixture(scope="module")
def clusters():
    """Both clusters; the port's detects 2 GPUs (faked)."""
    import ray_tpu
    import ray_tpu_torch

    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    saved = os.environ.get("RTT_NUM_GPUS")
    os.environ["RTT_NUM_GPUS"] = "2"
    try:
        ray_tpu.init(num_cpus=4)
        try:
            ray_tpu_torch.init(num_cpus=4)
            try:
                yield
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
    finally:
        if saved is None:
            os.environ.pop("RTT_NUM_GPUS", None)
        else:
            os.environ["RTT_NUM_GPUS"] = saved


def _sq(x):
    return x * x


def _addmul(a, b):
    return a * 10 + b


def _set_pool_init(v):
    os.environ["POOL_INIT"] = str(v)


def _read_pool_init(_):
    return os.environ.get("POOL_INIT")


def _visible(_):
    import time

    time.sleep(0.2)  # both actors take a share of the map
    return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")


class TestPool:
    def test_map_apply(self, clusters):
        def case(package):
            with _pkg(package, "util.multiprocessing").Pool(3) as p:
                return (p.map(_sq, range(10)), p.apply(_addmul, (3, 4)),
                        p.apply_async(_sq, (9,)).get(timeout=30),
                        p.starmap(_addmul, [(1, 2), (3, 4)]))

        assert _both(case) == ([i * i for i in range(10)], 34, 81, [12, 34])

    def test_imap_and_unordered(self, clusters):
        def case(package):
            with _pkg(package, "util.multiprocessing").Pool(2) as p:
                return (list(p.imap(_sq, range(8), chunksize=3)),
                        sorted(p.imap_unordered(_sq, range(8))))

        squares = [i * i for i in range(8)]
        assert _both(case) == (squares, squares)

    def test_initializer_and_close(self, clusters):
        def case(package):
            p = _pkg(package, "util.multiprocessing").Pool(
                2, initializer=_set_pool_init, initargs=(7,))
            out = p.map(_read_pool_init, range(2))
            p.close()
            with pytest.raises(ValueError, match="not running"):
                p.apply(_sq, (1,))
            p.join()
            p.terminate()
            return out

        assert _both(case) == ["7", "7"]

    def test_actors_pinned_to_gpus(self, clusters):
        """``ray_remote_args={"num_gpus": 1}``: each pool actor holds one
        of the 2 faked GPUs, its own."""
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(2, ray_remote_args={"num_gpus": 1}) as p:
            seen = dict(p.map(_visible, range(8), chunksize=1))
        assert sorted(seen.values()) == ["0", "1"]

    def test_num_tpus_raises(self, clusters):
        from ray_tpu_torch.util.multiprocessing import Pool

        with pytest.raises(ValueError, match="num_gpus"):
            Pool(1, ray_remote_args={"num_tpus": 1})


def test_joblib_backend(clusters):
    import joblib

    def case(package):
        _pkg(package, "util.joblib").register_ray()
        with joblib.parallel_backend(package):
            return joblib.Parallel()(joblib.delayed(_sq)(i)
                                     for i in range(12))

    assert _both(case) == [i * i for i in range(12)]


def _even(x):
    return x % 2 == 0


def test_parallel_iterator(clusters):
    def case(package):
        it = _pkg(package, "util.iter")
        out = [sorted(it.from_items(list(range(12)), num_shards=3)
                      .for_each(_sq).gather_sync()),
               sorted(it.from_range(10, num_shards=2).filter(_even)
                      .gather_async())]
        batches = list(it.from_items([1, 2, 3, 4, 5, 6], num_shards=2)
                       .batch(2).gather_sync())
        out.append((max(len(b) for b in batches),
                    sorted(x for b in batches for x in b)))
        u = it.from_items([1, 2], 1).union(it.from_items([3, 4], 1))
        out.append((sorted(u.gather_sync()), u.num_shards(),
                    len(it.from_range(100, 4).take(5))))
        return out

    assert _both(case) == [sorted(i * i for i in range(12)),
                           [0, 2, 4, 6, 8], (2, [1, 2, 3, 4, 5, 6]),
                           ([1, 2, 3, 4], 2, 5)]


class Member:
    def __init__(self, base):
        self.base = base

    def val(self, x):
        return self.base + x

    def whoami(self, rank):
        return rank


def test_actor_group(clusters):
    def case(package):
        g = _pkg(package, "util.actor_group").ActorGroup(
            Member, 4, init_args=(100,))
        out = (len(g), g.execute("val", 5), g.execute_single(2, "val", 1),
               g.execute_with_rank("whoami"))
        g.shutdown()
        return out + (len(g),)

    assert _both(case) == (4, [105] * 4, 101, [0, 1, 2, 3], 0)


def test_dask_scheduler_protocol(clusters):
    dsk = {"a": 1, "b": (add, "a", 2), "c": (mul, "b", (add, "b", 1)),
           "d": [(add, "b", "b"), "c"]}

    def case(package):
        get = _pkg(package, "util.dask").ray_dask_get
        return (get(dsk, "b"), get(dsk, "c"), get(dsk, "d"),
                get(dsk, ["b", "c"]))

    assert _both(case) == (3, 12, [6, 12], [3, 12])


def test_dask_cycle_detection(clusters):
    def case(package):
        with pytest.raises(ValueError, match="cycle") as err:
            _pkg(package, "util.dask").ray_dask_get(
                {"a": (len, "b"), "b": (len, "a")}, "a")
        return str(err.value)

    assert _both(case) == "cycle detected in dask graph at key 'a'"


def _installed(lib):
    try:
        __import__(lib)
        return True
    except ImportError:
        return False


@pytest.mark.parametrize("name,lib", [("XGBoostTrainer", "xgboost"),
                                      ("LightGBMTrainer", "lightgbm")])
def test_gbdt_trainers_gated(name, lib):
    """Without the library installed, construction raises naming it."""
    def case(package):
        cls = getattr(_pkg(package, "train"), name)
        if _installed(lib):
            return "installed"
        with pytest.raises(ImportError, match=lib) as err:
            cls(datasets={})
        return str(err.value)

    assert _both(case) in ("installed",
                           f"{name} requires `{lib}` to be installed.")


def test_train_exports():
    ours = set(_pkg("ray_tpu_torch", "train").__all__)
    theirs = set(_pkg("ray_tpu", "train").__all__)
    assert ours == theirs - {"JaxTrainer", "JaxBackendConfig"}
    assert {"TorchTrainer", "TorchBackendConfig"} <= ours


@pytest.mark.parametrize("stub", ["xgboost", "lightgbm"])
def test_util_stubs_redirect(stub):
    def case(package):
        with pytest.raises(DeprecationWarning) as err:
            importlib.import_module(f"{package}.util.{stub}")
        return str(err.value).replace(package, "PKG")

    assert "Use PKG.train." in _both(case)


def test_spark_stub_gated():
    def case(package):
        setup = _pkg(package, "util.spark").setup_ray_cluster
        if _installed("pyspark"):
            return "installed"
        with pytest.raises(ImportError, match="pyspark"):
            setup()
        return "gated"

    assert _both(case) in ("installed", "gated")


# -- experimental.collective in a compiled DAG ------------------------------

class Worker:
    """A DAG participant: ``grad`` scales the input, as numpy f32 in
    ray_tpu and as a bf16 tensor in the port; ``apply`` reports what the
    reduced value is."""

    def __init__(self, scale, as_tensor):
        self.scale = scale
        self.as_tensor = as_tensor

    def grad(self, x):
        g = np.asarray(x, np.float32) * self.scale
        if self.as_tensor:
            import torch

            return torch.from_numpy(g).to(torch.bfloat16)
        return g

    def apply(self, *reduced):
        out = []
        for g in reduced:
            values = g.float() if self.as_tensor else g
            out.append((type(g).__name__, str(g.dtype),
                        [float(v) for v in values]))
        return out


class Shaped:
    def __init__(self, n):
        self.n = n

    def out(self, x):
        return np.ones(self.n, np.float32)

    def identity(self, g):
        return g


OPS = ("SUM", "PRODUCT", "MIN", "MAX")


def test_allreduce_in_a_compiled_dag(clusters):
    """Three actors' outputs reduced by the hidden reducers (one per op)
    and read back by each: ray_tpu's reducers on numpy f32, the port's on
    bf16 tensors, which numpy cannot hold; the same values, and each side
    keeps its input's type."""
    kinds = {}

    def case(package):
        pkg = _pkg(package)
        dag = _pkg(package, "dag")
        collective = _pkg(package, "experimental.collective")
        ws = [pkg.remote(Worker).remote(s, package == "ray_tpu_torch")
              for s in (1.0, 2.0, 3.0)]
        with dag.InputNode() as inp:
            grads = [w.grad.bind(inp) for w in ws]
            reduced = [collective.allreduce.bind(
                grads, op=getattr(collective.ReduceOp, op)) for op in OPS]
            out = dag.MultiOutputNode([
                w.apply.bind(*(r[i] for r in reduced))
                for i, w in enumerate(ws)])
        compiled = out.experimental_compile()
        try:
            got = [compiled.execute(np.full(4, v, np.float32)).get()
                   for v in (1.0, 2.0)]
        finally:
            compiled.teardown()
            for w in ws:
                pkg.kill(w)
        kinds[package] = {(kind, dtype) for run in got for per_worker in run
                          for kind, dtype, _ in per_worker}
        return [[[vals for _, _, vals in per_worker] for per_worker in run]
                for run in got]

    values = _both(case)
    assert kinds == {"ray_tpu": {("ndarray", "float32")},
                     "ray_tpu_torch": {("Tensor", "torch.bfloat16")}}
    per = (lambda v: 6 * v, lambda v: 6 * v ** 3, lambda v: v,
           lambda v: 3 * v)
    assert values == [[[[f(v)] * 4 for f in per]] * 3 for v in (1.0, 2.0)]


def test_allreduce_shape_mismatch_errors(clusters):
    def case(package):
        pkg = _pkg(package)
        dag = _pkg(package, "dag")
        allreduce = _pkg(package, "experimental.collective").allreduce
        ws = [pkg.remote(Shaped).remote(2), pkg.remote(Shaped).remote(3)]
        with dag.InputNode() as inp:
            outs = [w.out.bind(inp) for w in ws]
            red = allreduce.bind(outs)
            out = dag.MultiOutputNode([w.identity.bind(g)
                                       for w, g in zip(ws, red)])
        compiled = out.experimental_compile()
        try:
            with pytest.raises(ValueError, match="shape") as err:
                compiled.execute(0).get()
        finally:
            compiled.teardown()
        return "must share one shape" in str(err.value)

    assert _both(case) is True


def test_port_reducer_keeps_the_input_type():
    """The reducer's arithmetic alone: torch ops in the tensors' dtype,
    numpy for anything else, the same values either way."""
    import torch

    from ray_tpu_torch.experimental import collective
    from ray_tpu_torch.util.collective.types import ReduceOp

    arrays = [np.array([1.5, -2.0, 4.0], np.float32) * s for s in (1, 2, 3)]
    for op in ReduceOp:
        fn = collective._torch_reducers()[op]
        t = fn([torch.from_numpy(a).to(torch.bfloat16) for a in arrays])
        n = collective._REDUCERS[op](arrays)
        assert t.dtype == torch.bfloat16 and isinstance(n, np.ndarray)
        assert t.float().tolist() == n.tolist()
