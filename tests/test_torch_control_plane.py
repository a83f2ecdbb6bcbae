"""ray_tpu_torch's copy of the control plane (``api``, ``_private``,
``util``, ``dag``, ``serve``, ``data``) on the CPU, and the static checks
that keep it apart from ray_tpu's.

The copy runs beside the JAX package's own tests, so it must share no
worker module, session or store directory, lock path or environment key
with it. One small cluster (2 CPUs) serves the module's runtime tests.
"""

import fnmatch
import os
import re
import shutil
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest

import ray_tpu_torch as rt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_tpu_torch")
REF = os.path.join(REPO, "ray_tpu")

# The copied control plane, the multi-host plane and the JAX-free parts
# of RLlib, by subpackage (module files under the port; _private holds
# daemon.py, usage.py and test_utils.py).
COPIED = ("api.py", "exceptions.py", "_private", "_native", "util", "dag",
          "serve", "data", "train", "rllib/utils", "rllib/connectors",
          "rllib/offline", "cluster_utils.py", "autoscaler", "tune", "air",
          "workflow", "job", "dashboard", "scripts", "experimental",
          "__main__.py")
# Keys of the reference's TPU detection that the port's GPU detection
# replaces (``_private/resources.py``): RAY_TPU_<name> -> its RTT_ key,
# or None where the port has no counterpart (GCE metadata serves TPU VMs).
# Every other key maps to RTT_<name>; the node daemon's (what it and
# cluster_utils read from the environment) are listed too.
RENAMED_KEYS = {"RAY_TPU_NUM_CHIPS": "RTT_NUM_GPUS",
                "RAY_TPU_USE_GCE_METADATA": None,
                "RAY_TPU_CLUSTER_TOKEN_HEX": "RTT_CLUSTER_TOKEN_HEX",
                "RAY_TPU_NODE_HOST": "RTT_NODE_HOST",
                "RAY_TPU_CLUSTER_DAEMONS": "RTT_CLUSTER_DAEMONS"}
DAEMON_KEYS = ("RAY_TPU_CLUSTER_TOKEN_HEX", "RAY_TPU_NODE_HOST",
               "RAY_TPU_CLUSTER_DAEMONS")


def _sources(root, part=""):
    path = os.path.join(root, part)
    if path.endswith(".py"):
        return [path]
    out = []
    for dirpath, _, names in os.walk(path):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _text(paths):
    return {p: open(p).read() for p in paths}


def _node_dirs(tmpdir):
    """Where a head started under ``tmpdir`` (None: this process's TMPDIR)
    puts its session, its store, a worker socket, its runtime envs and a
    host-copy lock, and what its stale-session sweep globs; computed in a
    fresh process, as a checkout with a TMPDIR of its own would."""
    code = textwrap.dedent("""
        import glob, json, os
        from ray_tpu_torch._private import netcomm, runtime_env
        from ray_tpu_torch._private.config import (session_dirs, shm_prefix,
                                                   temp_root)
        from ray_tpu_torch._private.runtime import _gc_stale_sessions
        seen = []
        glob.glob = lambda pattern: seen.append(pattern) or []
        _gc_stale_sessions()
        session = os.path.join(temp_root(), "rtt_sessions",
                               "session_1760000000_0123abcd")
        print(json.dumps({
            "session": session,
            "store": os.path.join("/dev/shm",
                                  shm_prefix() + os.path.basename(session)),
            "socket": os.path.join(session, "w_" + "0" * 16 + ".sock"),
            "envs": runtime_env._envs_root(),
            "lock": os.path.join(temp_root(), netcomm.HostCopyGate._PATH_FMT
                                 % (os.getuid(), 0)),
            "daemon": session_dirs("node_1760000000_4567cdef"),
            "globs": seen}))
    """)
    env = dict(os.environ)
    if tmpdir is not None:
        env["TMPDIR"] = tmpdir
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[-1]
    import json
    return json.loads(out)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2, num_gpus=1)
    yield rt.get_runtime_context()
    rt.shutdown()


class TestRuntime:
    def test_task(self, cluster):
        @rt.remote
        def add(a, b):
            return a + b

        assert rt.get([add.remote(i, 1) for i in range(4)]) == [1, 2, 3, 4]

    def test_actor_keeps_state_in_another_process(self, cluster):
        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n, os.getpid()

        c = Counter.remote()
        got = [rt.get(c.bump.remote()) for _ in range(3)]
        assert [n for n, _ in got] == [1, 2, 3]
        assert {pid for _, pid in got} != {os.getpid()}

    @pytest.mark.parametrize("nbytes", [64, 8 << 20])
    def test_put_get(self, cluster, nbytes):
        arr = np.random.default_rng(nbytes).integers(0, 255, nbytes,
                                                     dtype=np.uint8)
        np.testing.assert_array_equal(rt.get(rt.put(arr)), arr)

    def test_gpu_is_a_declared_resource(self, cluster):
        # The declared GPU is reserved and pinned: the task sees device 0
        # alone, and a task without a GPU sees none.
        assert rt.cluster_resources()["GPU"] == 1.0

        @rt.remote(num_gpus=1)
        def on_gpu():
            return os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_gpu_ids()

        @rt.remote
        def off_gpu():
            return os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_gpu_ids()

        assert rt.get(on_gpu.remote(), timeout=60) == ("0", [0])
        assert rt.get(off_gpu.remote(), timeout=60) == ("", [])

    def test_session_and_store_use_the_copy_prefix(self, cluster):
        from ray_tpu_torch._private import state

        from ray_tpu_torch._private.config import shm_prefix, temp_root

        node = state.current()
        assert node.session_dir.startswith(
            os.path.join(temp_root(), "rtt_sessions") + os.sep)
        assert node.store_dir.startswith(
            "/dev/shm/" + shm_prefix() + "session_")
        assert shm_prefix().startswith("rtt_")
        assert os.path.isdir(node.session_dir)

    def test_workers_boot_lean_without_jax_or_torch(self, cluster):
        @rt.remote
        def probe():
            mods = sys.modules
            return (sys.flags.no_site,
                    sorted(m for m in mods if m.split(".")[0] in (
                        "jax", "torch", "ray_tpu", "ml_dtypes")))

        no_site, loaded = rt.get(probe.remote())
        assert no_site == 1
        assert loaded == []

    def test_fuse_functions(self, cluster):
        @rt.remote
        def double(x):
            return 2 * x

        from ray_tpu_torch.dag import InputNode
        from ray_tpu_torch.dag.compiled import CudaGraphed

        with InputNode() as inp:
            out = double.bind(double.bind(inp))
        assert out.compile_fused(jit=False)(3) == 12
        # jit=True: one CUDA graph per signature; without a CUDA tensor
        # among the inputs the nodes run in order.
        fused = out.compile_fused()
        assert isinstance(fused, CudaGraphed)
        assert fused(3) == 12 and fused.graphs == {}

    def test_device_feed_raises(self, cluster):
        from ray_tpu_torch import data

        ds = data.from_items([{"x": i} for i in range(4)])
        assert [r["x"] for r in ds.take_all()] == [0, 1, 2, 3]
        # The feed runs on the card it is given: without one it raises,
        # and never hands back host tensors in its place.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ds.iter_torch_batches(batch_size=2, device="cuda")
        got = [b["x"] for b in ds.iter_torch_batches(batch_size=2,
                                                     device="cpu")]
        assert [t.tolist() for t in got] == [[0, 1], [2, 3]]


def test_shutdown_leaves_no_directories():
    """A whole cluster life in its own process: init, a task, a put
    through the shared-memory store, shutdown; then none of its
    directories is left."""
    code = textwrap.dedent("""
        import glob, json, os
        import numpy as np
        import ray_tpu_torch as rt
        rt.init(num_cpus=1)
        from ray_tpu_torch._private import state
        node = state.current()
        dirs = [node.session_dir, node.store_dir]
        @rt.remote
        def f(x):
            return x * 2
        assert rt.get(f.remote(21)) == 42
        big = np.ones(4 << 20, np.uint8)
        assert rt.get(rt.put(big)).sum() == big.sum()
        during = [os.path.isdir(d) for d in dirs]
        rt.shutdown()
        print(json.dumps({"dirs": dirs, "during": during,
                          "after": [os.path.exists(d) for d in dirs]}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip().splitlines()[-1]
    import json
    got = json.loads(out)
    assert got["during"] == [True, True]
    assert got["after"] == [False, False]
    assert got["dirs"][1].startswith("/dev/shm/rtt_")


class TestStaticIsolation:
    """The copy's source names nothing of ray_tpu's: no module string, no
    shared directory or lock path, no environment key."""

    @pytest.mark.parametrize("part", COPIED)
    def test_no_reference_module_strings(self, part):
        bad = [(p, m.group(0)) for p, t in _text(_sources(PORT, part)).items()
               for m in re.finditer(r"(?<![\w.])ray_tpu\b",
                                    t)]
        assert bad == []

    @pytest.mark.parametrize("part", COPIED)
    def test_no_reference_paths(self, part):
        bad = [(p, s) for p, t in _text(_sources(PORT, part)).items()
               for s in ("/dev/shm/ray_tpu", "/tmp/ray_tpu",
                         ".ray_tpu_host_copy", "libray_tpu.so")
               if s in t]
        assert bad == []

    @pytest.mark.parametrize("part", COPIED)
    def test_no_reference_env_prefix(self, part):
        bad = [(p, m.group(0)) for p, t in _text(_sources(PORT, part)).items()
               for m in re.finditer(r"RAY_TPU_\w*", t)]
        assert bad == []

    def test_env_keys_are_disjoint(self):
        def keys(root, prefix):
            found = set()
            for t in _text(_sources(root)).values():
                found.update(re.findall(prefix + r"[A-Z0-9_]+", t))
            return found

        ref_keys, port_keys = keys(REF, "RAY_TPU_"), keys(PORT, "RAY_TPU_")
        assert len(ref_keys) > 40
        assert ref_keys.isdisjoint(port_keys)
        # Each copied module reads RTT_<name> where its original reads
        # RAY_TPU_<name>, and ray_tpu reads no RTT_ key.
        renamed = 0
        for port_path in [f for part in COPIED for f in _sources(PORT, part)]:
            ref_path = port_path.replace(PORT, REF, 1)
            if not os.path.exists(ref_path):
                continue
            ref_text, port_text = open(ref_path).read(), open(port_path).read()
            for key in set(re.findall(r"RAY_TPU_[A-Z0-9_]+", ref_text)):
                want = RENAMED_KEYS.get(key, "RTT_" + key[len("RAY_TPU_"):])
                assert want is None or want in port_text, key
                renamed += 1
        assert renamed > 40
        assert keys(REF, "RTT_") == set()

    @pytest.mark.parametrize("key", DAEMON_KEYS)
    def test_daemon_keys_are_renamed(self, key):
        ref = "".join(open(os.path.join(REF, *p.split("/"))).read() for p in
                      ("_private/daemon.py", "cluster_utils.py"))
        port = "".join(open(os.path.join(PORT, *p.split("/"))).read()
                       for p in ("_private/daemon.py", "cluster_utils.py"))
        assert key in ref and RENAMED_KEYS[key] in port and key not in port

    def test_daemon_entry_module_is_the_copys(self):
        src = open(os.path.join(PORT, "cluster_utils.py")).read()
        assert '"-m", "ray_tpu_torch._private.daemon"' in src
        assert '"--num-gpus"' in src and "--num-tpus" not in src

    def test_worker_entry_module_is_the_copys(self):
        src = open(os.path.join(PORT, "_private", "scheduler.py")).read()
        assert '"-m", "ray_tpu_torch._private.worker_proc"' in src
        assert "JAX" not in src[src.index("worker_lean_boot"):][:600]

    def test_stale_session_sweeps_do_not_overlap(self):
        ref = open(os.path.join(REF, "_private", "runtime.py")).read()
        ref_globs = re.findall(r'glob\.glob\(\s*"([^"]+)"', ref)
        port = _node_dirs(None)
        port_globs = port["globs"]
        assert ref_globs and len(port_globs) == 2
        # the head's and a node daemon's (daemon.py)
        port_dirs = [port["store"], port["session"], *port["daemon"]]
        ref_dirs = ["/dev/shm/ray_tpu_session_1_ab",
                    "/tmp/ray_tpu_sessions/s_1",
                    "/dev/shm/ray_tpu_node_1_ab",
                    "/tmp/ray_tpu_sessions/node_1_ab"]
        ref_daemon = open(os.path.join(REF, "_private", "daemon.py")).read()
        assert '"/tmp/ray_tpu_sessions"' in ref_daemon
        assert 'f"ray_tpu_{session_name}"' in ref_daemon
        assert not any(fnmatch.fnmatch(d, g)
                       for d in port_dirs for g in ref_globs)
        assert not any(fnmatch.fnmatch(d, g)
                       for d in ref_dirs for g in port_globs)
        assert all(any(fnmatch.fnmatch(d, g) for g in port_globs)
                   for d in port_dirs)

    @pytest.mark.parametrize("long_tmpdir", [False, True])
    def test_two_tmpdirs_share_no_directory(self, tmp_path, long_tmpdir):
        """Two checkouts on one machine, each under a TMPDIR of its own
        (one of them too long for the worker sockets): their sessions,
        stores, runtime envs and host-copy locks are apart, and neither
        one's stale-session sweep matches the other's directories."""
        import tempfile

        if long_tmpdir:
            tmpdirs = [tmp_path / ("a" * 60), tmp_path / ("b" * 60)]
            for d in tmpdirs:
                d.mkdir()
        else:  # short enough to hold the sockets itself
            tmpdirs = [tempfile.mkdtemp(prefix="rt", dir="/tmp")
                       for _ in range(2)]
        try:
            a, b = (_node_dirs(str(d)) for d in tmpdirs)
        finally:
            for d in tmpdirs if not long_tmpdir else ():
                shutil.rmtree(d)
        if long_tmpdir:  # each maps to a short /tmp/rtt_<tag> of its own
            for got in (a, b):
                shutil.rmtree(os.path.dirname(got["envs"]))
        else:
            assert a["envs"].startswith(str(tmpdirs[0]) + os.sep)
        for key in ("session", "store", "envs", "lock", "daemon"):
            assert a[key] != b[key], key
        assert a["store"].startswith("/dev/shm/rtt_")
        assert len(a["socket"]) <= 107 and len(b["socket"]) <= 107
        for mine, theirs in ((a, b), (b, a)):
            globs = mine["globs"]
            assert all(any(fnmatch.fnmatch(d, g) for g in globs)
                       for d in [mine["session"], mine["store"],
                                 *mine["daemon"]])
            assert not any(fnmatch.fnmatch(d, g) for g in globs
                           for d in [theirs["session"], theirs["store"],
                                     *theirs["daemon"]])

    def test_library_paths_and_keys_are_the_ports(self, tmp_path,
                                                  monkeypatch):
        """The workflow storage (its default and its environment key), the
        job's log file and the job-id key its entrypoint reads are the
        port's own, so both packages' libraries run side by side."""
        from ray_tpu import job as ref_job
        from ray_tpu import workflow as ref_workflow
        from ray_tpu_torch import job, workflow
        from ray_tpu_torch._private.config import temp_root

        monkeypatch.setenv("HOME", str(tmp_path))
        for key in ("RTT_WORKFLOW_STORAGE", "RAY_TPU_WORKFLOW_STORAGE"):
            monkeypatch.delenv(key, raising=False)
        for module in (workflow, ref_workflow):
            monkeypatch.setattr(module, "_storage_dir", None)
        assert workflow.init() == str(tmp_path / ".cache/rtt/workflows")
        assert ref_workflow.init() == str(
            tmp_path / ".cache/ray_tpu/workflows")
        monkeypatch.setenv("RTT_WORKFLOW_STORAGE", str(tmp_path / "ours"))
        assert workflow.init() == str(tmp_path / "ours")
        assert ref_workflow.init() == str(
            tmp_path / ".cache/ray_tpu/workflows")

        # A unique id: ray_tpu's log lies under the fixed /tmp, which
        # another run of this test on the machine may share.
        job_id = f"raysubmit_iso_{uuid.uuid4().hex[:8]}"
        logs = {}
        for module in (job, ref_job):
            monkeypatch.setattr(module.JobSupervisor, "_set_status",
                                lambda self, *a, **k: None)
            sup = module.JobSupervisor(
                job_id, 'echo "rtt=$RTT_JOB_ID '
                'ray_tpu=$RAY_TPU_JOB_ID"', {"working_dir": str(tmp_path)},
                None)
            try:
                assert sup.run() == "SUCCEEDED"
                with open(sup.log_path) as f:
                    logs[module.__name__] = (sup.log_path, f.read())
            finally:
                os.unlink(sup.log_path)
        assert logs["ray_tpu_torch.job"] == (
            os.path.join(temp_root(), f"rtt_job_{job_id}.log"),
            f"rtt={job_id} ray_tpu=\n")
        assert logs["ray_tpu.job"] == (f"/tmp/ray_tpu_job_{job_id}.log",
                                       f"rtt= ray_tpu={job_id}\n")

    def test_import_loads_no_torch(self):
        # The text stages and the Processor too: their pool actors start
        # without torch (only GPTInferenceStage imports it, when built).
        code = ("import sys, ray_tpu_torch, ray_tpu_torch.serve, "
                "ray_tpu_torch.data, ray_tpu_torch.llm\n"
                "from ray_tpu_torch.llm import TokenizeStage, Processor\n"
                "TokenizeStage()({'prompt': ['hi']})\n"
                "print(sorted(m for m in sys.modules "
                "if m.split('.')[0] == 'torch'))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.strip()
        assert out == "[]"


def test_ragged_batch_columns_become_object_columns():
    """A map_batches function may return ragged columns (the token ids of
    prompts of different lengths); the block keeps them as an object
    column, as block_from_rows does, where ray_tpu's from_batch_format
    raises."""
    from ray_tpu_torch.data import block

    out = block.from_batch_format({
        "tokens": [np.arange(2), np.arange(5)], "n": [2, 5]})
    assert out["tokens"].dtype == object and len(out["tokens"]) == 2
    np.testing.assert_array_equal(out["tokens"][1], np.arange(5))
    assert out["n"].dtype.kind == "i"
