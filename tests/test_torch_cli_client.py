"""The port's CLI (``scripts/cli.py``, ``python -m ray_tpu_torch``) and
remote-driver client (``util/client``) held against ``ray_tpu``'s.

Both packages' in-process clusters are alive in this module (2 CPUs
each; ray_tpu's declares 1 TPU, the port's 1 GPU, both faked): every CLI
command runs in each through its ``main``, with the same exit codes and
output of the same structure, the accelerator key renamed. Then each
package's head and node run as subprocesses of its CLI, a client drives
each cluster in this process and from another one, and the port's head
is killed and restarted under a live client and a CLI node. The port's
client pickles through the port's serializer, whose ``_to_host`` brings
every tensor it meets to host.
"""

import contextlib
import importlib
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
ACCEL = {"ray_tpu": "TPU", "ray_tpu_torch": "GPU"}
PREFIX = {"ray_tpu": "RAY_TPU_", "ray_tpu_torch": "RTT_"}
# Metric families whose names name the accelerator.
RENAMED_METRICS = {"node_free_tpu_chips": "node_free_gpus"}


def _pkg(package, sub=""):
    return importlib.import_module(package + (f".{sub}" if sub else ""))


@pytest.fixture(scope="module")
def clusters():
    import ray_tpu
    import ray_tpu_torch

    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    for package in PACKAGES:
        _pkg(package, "util.metrics").clear_registry()
        # The head's per-message ingest counts are module state that
        # outlives a cluster: an earlier test's daemon traffic in this
        # process would expose a metric family in one package only.
        telemetry = _pkg(package, "_private.telemetry")
        with telemetry._msg_counts_lock:
            telemetry._msg_counts.clear()
    ray_tpu.init(num_cpus=2, num_tpus=1)
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=1)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
    finally:
        ray_tpu.shutdown()


def _both(case):
    out = {package: case(package) for package in PACKAGES}
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu"]


def _gpu(value):
    """A structure with ray_tpu's accelerator names renamed to the port's."""
    if isinstance(value, dict):
        return {_gpu(k): _gpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_gpu(v) for v in value)
    if isinstance(value, str):
        return RENAMED_METRICS.get(value, "GPU" if value == "TPU" else value)
    return value


def _main(package, args):
    """(exit code, standard output) of ``package``'s CLI ``main(args)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _pkg(package, "scripts.cli").main(args)
    return rc, buf.getvalue()


def _status(text):
    """``status`` output as {resource: [available, total]} and the nodes."""
    res = {m.group(1): [float(m.group(2)), float(m.group(3))] for m in
           re.finditer(r"^\s+(\S+): (\S+)/(\S+) available$", text, re.M)}
    nodes = re.search(r"^\s+nodes: (\d+)$", text, re.M)
    return {"resources": res, "nodes": int(nodes.group(1)) if nodes else None,
            "title": text.splitlines()[0]}


def _shape(value):
    """The keys of a JSON structure, every leaf replaced by its type."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(v) for v in value]
    return type(value).__name__


def _structure(args, text):
    if args[0] == "status":
        out = _status(text)
        out["resources"] = sorted(out["resources"])  # memory differs
        return out
    if args[0] == "metrics":
        return sorted(set(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M)))
    return _shape(json.loads(text))


class TestCommands:
    @pytest.mark.parametrize("args", [["status"], ["list", "nodes"],
                                      ["summary"], ["metrics"]],
                             ids=lambda a: " ".join(a))
    def test_same_exit_code_and_structure(self, clusters, args):
        def case(package):
            rc, text = _main(package, args)
            out = (rc, _structure(args, text))
            return _gpu(out) if package == "ray_tpu" else out

        rc, structure = _both(case)
        assert rc == 0 and structure

    def test_status_counts_the_accelerator(self, clusters):
        def case(package):
            out = _status(_main(package, ["status"])[1])
            return out["resources"][ACCEL[package]], out["nodes"]

        assert _both(case) == ([1.0, 1.0], 1)

    def test_timeline(self, clusters, tmp_path):
        def case(package):
            path = tmp_path / f"{package}.json"
            rc, text = _main(package, ["timeline", "-o", str(path)])
            return rc, text.replace(str(path), "PATH"), \
                type(json.loads(path.read_text())).__name__

        assert _both(case) == (
            0, "wrote Chrome-trace timeline to PATH (open in "
               "ui.perfetto.dev)\n", "list")

    def test_parser_commands_are_the_references(self):
        def commands(package):
            parser = _pkg(package, "scripts.cli").build_parser()
            (sub,) = [a for a in parser._actions if a.dest == "cmd"]
            return sorted(sub.choices), parser.prog

        ref, port = commands("ray_tpu"), commands("ray_tpu_torch")
        assert port == (ref[0], "ray_tpu_torch")


class TestNodeResources:
    """A node's ``--resources``: ``"GPU"`` is its card count, never a
    custom resource; ``"TPU"`` raises."""

    @pytest.mark.parametrize("text,want", [
        (None, (None, None)),
        ('{"GPU": 1}', (1, None)),
        ('{"GPU": 2, "W": 1}', (2, {"W": 1})),
        ('{"W": 3}', (None, {"W": 3})),
        ('{"TPU": 0, "W": 1}', (None, {"W": 1})),
    ])
    def test_gpu_becomes_num_gpus(self, text, want):
        from ray_tpu_torch.scripts.cli import node_resources

        assert node_resources(text) == want

    def test_tpu_raises_before_joining(self):
        from ray_tpu_torch.scripts.cli import main

        with pytest.raises(ValueError, match="GPU"):
            main(["start", "--address", "127.0.0.1:1", "--token-hex",
                  "00" * 16, "--resources", '{"TPU": 1}'])


# -- CLI processes -----------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(package, **keys):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for key, value in keys.items():
        env[PREFIX[package] + key] = str(value)
    return env


class _Cli:
    """``python -m <package> <args>`` in a process group of its own, its
    output collected by a thread."""

    def __init__(self, package, args, env):
        import threading

        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", package, *args], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, pattern):
        deadline = time.monotonic() + TIMEOUT
        while True:
            for line in self.lines:
                m = re.search(pattern, line)
                if m:
                    return m
            assert self.proc.poll() is None, self.lines[-20:]
            assert time.monotonic() < deadline, self.lines[-20:]
            time.sleep(0.05)

    def stop(self, sig):
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        try:
            return self.proc.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=TIMEOUT)
            return None


def _start_head(package, **keys):
    head = _Cli(package, ["start", "--host", "127.0.0.1", "--port",
                          str(_free_port()), "--dashboard-port", "0",
                          "--num-cpus", "2"], _env(package, **keys))
    banner = {key: head.wait_for(rf"^\s+{label}:\s+(\S+)").group(1)
              for key, label in (("client", "client address"),
                                 ("cluster", "cluster address"),
                                 ("token", "cluster token"))}
    return head, banner


class TestCliProcesses:
    def test_head_and_node_then_status(self):
        """Each package's head and a node that declares one accelerator
        (ray_tpu's faked chip; the port's ``--resources '{"GPU": 1}'``),
        read by ``status --address``; after SIGINT to the head and
        SIGTERM to the port's node, nothing of the port's is left."""
        from ray_tpu_torch._private.test_utils import group_members, owned_dirs

        def case(package):
            head, banner = _start_head(
                package, **({"NUM_CHIPS": 0} if package == "ray_tpu"
                            else {"NUM_GPUS": 0}))
            node = None
            try:
                if package == "ray_tpu":
                    node = _Cli(package, ["start", "--address",
                                          banner["cluster"], "--token-hex",
                                          banner["token"], "--num-cpus", "1"],
                                _env(package, NUM_CHIPS=1))
                else:
                    node = _Cli(package, ["start", "--address",
                                          banner["cluster"], "--token-hex",
                                          banner["token"], "--num-cpus", "1",
                                          "--resources", '{"GPU": 1}'],
                                _env(package, NUM_GPUS=0))
                node.wait_for("node daemon joined")
                env = _env(package, CLUSTER_TOKEN_HEX=banner["token"])
                out = subprocess.run(
                    [sys.executable, "-m", package, "status", "--address",
                     banner["client"]], cwd=REPO, env=env,
                    capture_output=True, text=True, timeout=TIMEOUT)
                status = _status(out.stdout)
                status["resources"] = {
                    k: v for k, v in status["resources"].items()
                    if k != "memory"}
                result = (out.returncode, status)
            finally:
                # ray_tpu's CLI node leaves its directories on SIGTERM (it
                # has no handler); SIGINT runs its shutdown.
                node_exit = node.stop(signal.SIGTERM if package ==
                                      "ray_tpu_torch" else signal.SIGINT) \
                    if node is not None else None
                head_exit = head.stop(signal.SIGINT)
            if package == "ray_tpu_torch":
                assert (head_exit, node_exit) == (0, 0)
                pids = (head.proc.pid, node.proc.pid)
                deadline = time.monotonic() + TIMEOUT
                while any(group_members(p) or owned_dirs(p) for p in pids):
                    assert time.monotonic() < deadline, \
                        [(group_members(p), owned_dirs(p)) for p in pids]
                    time.sleep(0.05)
            return _gpu(result) if package == "ray_tpu" else result

        assert _both(case) == (
            0, {"resources": {"CPU": [3.0, 3.0], "GPU": [1.0, 1.0]},
                "nodes": 2, "title": "======== Cluster status ========"})


# -- the client --------------------------------------------------------------

def double(x):
    return x * 2


def total(xs):
    return sum(xs)


class Acc:
    def __init__(self, base):
        self.v = base

    def add(self, x):
        self.v += x
        return self.v


def describe(payload):
    """The nested tensor as the task received it."""
    t = payload["w"][0]
    return type(t).__name__, str(t.dtype), str(t.device), float(t.sum())


def _serve(package):
    host, port = _pkg(package, "util.client").server.serve("127.0.0.1", 0)
    return f"{host}:{port}"


class TestClient:
    def test_round_trip(self, clusters):
        def case(package):
            conn = _pkg(package, "util.client").connect(_serve(package))
            try:
                ref = conn.remote(double).remote(21)
                data = conn.put([1, 2, 3])
                acc = conn.remote(Acc).remote(10)
                return (conn.get(ref), conn.get(conn.remote(total).remote(data)),
                        conn.get(acc.add.remote(5)), conn.get(acc.add.remote(1)),
                        conn.api_call("cluster_resources")["CPU"])
            finally:
                conn.close()

        assert _both(case) == (42, 6, 15, 16, 2.0)

    def test_from_a_separate_process(self, clusters):
        """Another process drives each cluster through the client, the
        token from the package's CLUSTER_TOKEN_HEX."""
        def case(package):
            token = _pkg(package, "_private.state").current().cluster_token
            code = (f"from {package}.util import client\n"
                    f"conn = client.connect({_serve(package)!r})\n"
                    f"rf = conn.remote(lambda x: x ** 2)\n"
                    f"print('result:', conn.get(rf.remote(9)))\n"
                    f"conn.close()\n")
            out = subprocess.run(
                [sys.executable, "-c", code], cwd=REPO,
                env=_env(package, CLUSTER_TOKEN_HEX=token.hex()),
                capture_output=True, text=True, timeout=TIMEOUT)
            assert out.returncode == 0, out.stderr[-2000:]
            return out.stdout.strip()

        assert _both(case) == "result: 81"

    def test_payloads_go_through_the_ports_pickler(self, clusters,
                                                   monkeypatch):
        """A tensor nested in a task's argument and in a put value is
        handed to ``_to_host`` on the way out, so it reaches the server
        (and the task) as a host tensor of its dtype and values."""
        import torch

        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.util import client

        seen = []
        to_host = serialization._to_host

        def recording(obj):
            if isinstance(obj, torch.Tensor):
                seen.append(obj)
            return to_host(obj)

        monkeypatch.setattr(serialization, "_to_host", recording)
        w = torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
        conn = client.connect(_serve("ray_tpu_torch"))
        try:
            got = conn.get(conn.remote(describe).remote({"w": [w]}))
            assert any(t is w for t in seen)
            assert got == ("Tensor", "torch.bfloat16", "cpu", 28.0)
            seen.clear()
            back = conn.get(conn.put({"nested": (w,)}))
            assert any(t is w for t in seen)
            assert back["nested"][0].dtype == torch.bfloat16
            assert torch.equal(back["nested"][0], w)
        finally:
            conn.close()

    def test_token_key_is_the_ports(self, clusters, monkeypatch):
        from ray_tpu_torch.util.client import client

        monkeypatch.setenv("RTT_CLUSTER_TOKEN_HEX", "ab" * 16)
        assert client._resolve_token(None) == bytes.fromhex("ab" * 16)


def test_head_sigkill_restart_same_session(tmp_path):
    """test_head_restart.py's case on the port, through its CLI: a head
    (``python -m ray_tpu_torch start``) on a storage path and a CLI node
    that rejoins; the head SIGKILLed mid-task and restarted on the same
    ports and storage; the same client session goes on."""
    from ray_tpu_torch.exceptions import HeadConnectionError
    from ray_tpu_torch.util.client import connect

    token = "ab" * 16
    keys = {"CLUSTER_TOKEN_HEX": token,
            "GCS_STORAGE_PATH": str(tmp_path / "gcs.sqlite"),
            "HEAD_PORT": _free_port(), "NUM_GPUS": 0}
    client_port = _free_port()
    args = ["start", "--host", "127.0.0.1", "--port", str(client_port),
            "--dashboard-port", "0", "--num-cpus", "2"]

    def connect_with_retry():
        deadline = time.monotonic() + TIMEOUT
        while True:
            try:
                return connect(f"127.0.0.1:{client_port}", token=token)
            except Exception:  # noqa: BLE001 - the head is still booting
                assert time.monotonic() < deadline
                time.sleep(0.2)

    head = _Cli("ray_tpu_torch", args, _env("ray_tpu_torch", **keys))
    node = head2 = conn = None
    try:
        conn = connect_with_retry()
        node = _Cli("ray_tpu_torch",
                    ["start", "--address", f"127.0.0.1:{keys['HEAD_PORT']}",
                     "--num-cpus", "2", "--resources", '{"W": 2}'],
                    _env("ray_tpu_torch", CLUSTER_TOKEN_HEX=token,
                         HEAD_RECONNECT_ATTEMPTS=60, NUM_GPUS=0))

        def alive():
            return sum(1 for n in conn.api_call("list_nodes")
                       if n.get("alive", True))

        deadline = time.monotonic() + TIMEOUT
        while alive() < 2:
            assert time.monotonic() < deadline, "the node never joined"
            time.sleep(0.2)

        def sq(x):
            return x * x

        def slow(x):
            import time as _t
            _t.sleep(30)
            return x

        f = conn.remote(sq)
        assert conn.get(f.remote(7)) == 49
        assert conn.get(f.options(resources={"W": 1}).remote(8)) == 64
        inflight = conn.remote(slow).remote(1)
        time.sleep(1.0)
        head.proc.send_signal(signal.SIGKILL)
        head.proc.wait(timeout=10)

        head2 = _Cli("ray_tpu_torch", args, _env("ray_tpu_torch", **keys))
        with pytest.raises(HeadConnectionError):
            conn.get(inflight, timeout=120)
        assert conn.get(f.remote(9)) == 81
        deadline = time.monotonic() + TIMEOUT
        while True:
            try:
                if alive() >= 2:
                    break
            except Exception:  # noqa: BLE001 - the head is restarting
                pass
            assert time.monotonic() < deadline, "the node did not rejoin"
            time.sleep(0.2)
        assert conn.get(f.options(resources={"W": 1}).remote(12)) == 144
    finally:
        if conn is not None:
            conn.close()
        for proc, sig in ((head2, signal.SIGINT), (node, signal.SIGTERM),
                          (head, signal.SIGKILL)):
            if proc is not None:
                proc.stop(sig)
