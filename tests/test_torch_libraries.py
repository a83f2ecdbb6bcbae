"""The port's Workflow, Jobs, Dashboard and AIR held against ``ray_tpu``'s.

Both packages' clusters are alive in this process (2 CPUs each; the
port's declares 1 GPU, faked, with ``num_gpus=1``). Every case runs once
in each package, through that package's API, and the results must be
equal (where a value names its package, a job's environment key or the
dashboard's title, each side's own name is expected). The step
functions are plain functions of this module, which imports neither
package at module level: the worker processes import it by name.
"""

import importlib
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
import uuid

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
TIMEOUT = 60


def _pkg(package, sub=""):
    return importlib.import_module(package + (f".{sub}" if sub else ""))


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Both clusters, each with workflow storage of its own."""
    import ray_tpu
    import ray_tpu_torch

    # Start from fresh clusters and empty metric registries: a cluster
    # or metrics left by an earlier test file in this process would show
    # on one side's /metrics only.
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    for package in PACKAGES:
        _pkg(package, "util.metrics").clear_registry()
    ray_tpu.init(num_cpus=2)
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=1)
        try:
            for package in PACKAGES:
                _pkg(package, "workflow").init(
                    str(tmp_path_factory.mktemp(f"wf_{package}")))
            yield
        finally:
            ray_tpu_torch.shutdown()
    finally:
        ray_tpu.shutdown()


def _both(case):
    """``case(package)`` in each package: the port's result, which must
    equal ray_tpu's."""
    out = {package: case(package) for package in PACKAGES}
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu"]


# -- workflow steps ---------------------------------------------------------

def add(x, y):
    return x + y


def mul(x, k):
    return x * k


def record(x, tag, marker_dir):
    """x + 1, leaving a file for each run in ``marker_dir``."""
    n = len([f for f in os.listdir(marker_dir) if f.startswith(tag)])
    open(os.path.join(marker_dir, f"{tag}_{n}"), "w").close()
    return x + 1


def flaky(x, marker_dir):
    """Fails on its first run, then returns x * 10."""
    armed = os.path.join(marker_dir, "armed")
    if not os.path.exists(armed):
        open(armed, "w").close()
        raise RuntimeError("injected failure")
    return x * 10


def decide(x, package):
    """A continuation: returns a sub-DAG of ``package``."""
    return _pkg(package).remote(add).bind(x, 100)


def combine(payload, y):
    return (payload, y)


def flaky_until(marker, succeed_at):
    """Fails until its ``succeed_at``-th attempt, counting attempts in
    ``marker``."""
    n = int(open(marker).read()) if os.path.exists(marker) else 0
    with open(marker, "w") as f:
        f.write(str(n + 1))
    if n + 1 < succeed_at:
        raise ValueError(f"boom on attempt {n + 1}")
    return "ok"


def always_fails():
    raise RuntimeError("nope")


def _remote(package, fn):
    return _pkg(package).remote(fn)


def _wf_id(tag):
    return f"wf_{tag}_{uuid.uuid4().hex[:8]}"


class TestWorkflow:
    def test_outputs_and_status(self, clusters):
        def case(package):
            wf, dag = _pkg(package, "workflow"), _pkg(package, "dag")
            with dag.InputNode() as inp:
                one = _remote(package, add).bind(
                    _remote(package, mul).bind(inp, 3), 1)
            with dag.InputNode() as inp:
                many = dag.MultiOutputNode([_remote(package, mul).bind(inp, 2),
                                            _remote(package, mul).bind(inp, 5)])
            a, b = _wf_id("one"), _wf_id("many")
            return (wf.run(one, 5, workflow_id=a), wf.get_status(a),
                    wf.get_output(a), wf.run(many, 3, workflow_id=b))

        assert _both(case) == (16, "SUCCESSFUL", 16, [6, 15])

    def test_resume_skips_completed_steps(self, clusters, tmp_path):
        def case(package):
            wf, dag = _pkg(package, "workflow"), _pkg(package, "dag")
            marker = tmp_path / package
            marker.mkdir()
            with dag.InputNode() as inp:
                step1 = _remote(package, record).bind(inp, "s1", str(marker))
                node = _remote(package, flaky).bind(step1, str(marker))
            wid = _wf_id("resume")
            with pytest.raises(Exception, match="injected"):
                wf.run(node, 1, workflow_id=wid, max_retries=0)
            failed = wf.get_status(wid)
            out = wf.resume(wid)
            runs = sorted(f for f in os.listdir(marker) if f.startswith("s1"))
            return failed, out, wf.get_status(wid), runs, wf.resume(wid)

        # step 1 ran once across run and resume; a finished workflow's
        # resume reads its stored output
        assert _both(case) == ("FAILED", 20, "SUCCESSFUL", ["s1_0"], 20)

    def test_continuation(self, clusters):
        def case(package):
            wf, dag = _pkg(package, "workflow"), _pkg(package, "dag")
            with dag.InputNode() as inp:
                node = _remote(package, decide).bind(inp, package)
            return wf.run(node, 5, workflow_id=_wf_id("cont"))

        assert _both(case) == 105

    @pytest.mark.parametrize("kind", ["file", "http", "timer"])
    def test_events(self, clusters, kind):
        def case(package):
            wf = _pkg(package, "workflow")
            key = f"evt-{kind}-{uuid.uuid4().hex[:6]}"
            provider = None
            if kind == "timer":
                t0 = time.time()
                node = wf.wait_for_event(wf.TimerListener, 0.2)
                return wf.run(node, workflow_id=_wf_id(kind)) >= t0 + 0.2
            if kind == "file":
                deliver = lambda: wf.deliver_event(key, {"n": 41})  # noqa
            else:
                provider = wf.HTTPEventProvider().start()

                def deliver():
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{provider.port}/event/{key}",
                        data=json.dumps({"n": 41}).encode(),
                        headers={"Content-Type": "application/json"})
                    urllib.request.urlopen(req, timeout=TIMEOUT).read()
            try:
                node = _remote(package, combine).bind(
                    wf.wait_for_event(wf.FileEventListener, key,
                                      timeout_s=TIMEOUT), 7)
                timer = threading.Timer(0.3, deliver)
                timer.start()
                wid = _wf_id(kind)
                out = wf.run(node, workflow_id=wid)
                timer.join(TIMEOUT)
                # the payload is stored: resume does not wait again
                return out, wf.resume(wid)
            finally:
                if provider is not None:
                    provider.stop()

        want = True if kind == "timer" else (({"n": 41}, 7),) * 2
        assert _both(case) == want

    def test_event_timeout_fails_the_workflow(self, clusters):
        def case(package):
            wf = _pkg(package, "workflow")
            node = wf.wait_for_event(wf.FileEventListener, "never",
                                     timeout_s=0.2, poll_interval_s=0.05)
            wid = _wf_id("timeout")
            with pytest.raises(Exception, match="not delivered"):
                wf.run(node, workflow_id=wid, max_retries=0)
            return wf.get_status(wid)

        assert _both(case) == "FAILED"

    @pytest.mark.parametrize("step_retries,run_retries,succeed_at,want", [
        (3, 0, 3, ("ok", 3)),         # the step's budget beats the run's
        (0, 5, 2, ("raised", 1)),     # and can tighten it
    ])
    def test_step_retries(self, clusters, tmp_path, step_retries,
                          run_retries, succeed_at, want):
        def case(package):
            wf = _pkg(package, "workflow")
            marker = str(tmp_path / f"{package}_attempts")
            step = wf.options(max_retries=step_retries)(
                _remote(package, flaky_until).bind(marker, succeed_at))
            try:
                out = wf.run(step, workflow_id=_wf_id("retries"),
                             max_retries=run_retries)
            except Exception:  # noqa: BLE001 — the outcome is compared
                out = "raised"
            return out, int(open(marker).read())

        assert _both(case) == want

    def test_catch_exceptions(self, clusters):
        def case(package):
            wf = _pkg(package, "workflow")
            bad = wf.options(catch_exceptions=True, max_retries=0)(
                _remote(package, always_fails).bind())
            result, err = wf.run(bad, workflow_id=_wf_id("catch"))
            good = wf.options(catch_exceptions=True)(
                _remote(package, add).bind(2, 3))
            return result, "nope" in str(err), wf.run(
                good, workflow_id=_wf_id("catch_ok"))

        assert _both(case) == (None, True, (5, None))

    def test_options_on_the_remote_function(self, clusters, tmp_path):
        def case(package):
            wf = _pkg(package, "workflow")
            marker = str(tmp_path / f"{package}_fn_attempts")
            fn = wf.options(max_retries=2)(_remote(package, flaky_until))
            out = wf.run(fn.bind(marker, 2), workflow_id=_wf_id("fn_tag"),
                         max_retries=0)
            return out, int(open(marker).read())

        assert _both(case) == ("ok", 2)

    def test_run_async_list_all_and_delete(self, clusters):
        def case(package):
            ray, wf = _pkg(package), _pkg(package, "workflow")
            dag = _pkg(package, "dag")
            with dag.InputNode() as inp:
                node = _remote(package, mul).bind(inp, 7)
            wid = _wf_id("async")
            out = ray.get(wf.run_async(node, 6, workflow_id=wid),
                          timeout=TIMEOUT)
            listed = dict(wf.list_all()).get(wid)
            filtered = (wid, "SUCCESSFUL") in wf.list_all(["SUCCESSFUL"])
            failed_only = wid in dict(wf.list_all(["FAILED"]))
            wf.delete(wid)
            return (out, listed, filtered, failed_only, wf.get_status(wid),
                    wid in dict(wf.list_all()))

        assert _both(case) == (42, "SUCCESSFUL", True, False, None, False)


# -- jobs -------------------------------------------------------------------

JOB_KEY = {"ray_tpu": "RAY_TPU_JOB_ID", "ray_tpu_torch": "RTT_JOB_ID"}


def _client(package):
    return _pkg(package, "job").JobSubmissionClient()


def _job_id(tag):
    return f"raysubmit_{tag}_{uuid.uuid4().hex[:8]}"


def _wait_status(client, job_id, statuses):
    deadline = time.monotonic() + TIMEOUT
    while client.get_job_status(job_id) not in statuses:
        assert time.monotonic() < deadline, client.get_job_info(job_id)
        time.sleep(0.05)
    return client.get_job_status(job_id)


class TestJobs:
    @pytest.mark.parametrize("code,status", [(0, "SUCCEEDED"),
                                             (3, "FAILED")])
    def test_status_exit_code_and_logs(self, clusters, code, status):
        def case(package):
            client = _client(package)
            key = JOB_KEY[package]
            job_id = client.submit_job(
                entrypoint=f'echo "job=${key}"; echo to-stderr >&2; '
                           f'exit {code}',
                submission_id=_job_id("exit"), metadata={"who": "test"},
                runtime_env={"env_vars": {"GREETING": "hi"}})
            final = client.wait_until_finish(job_id, timeout=TIMEOUT)
            info = client.get_job_info(job_id)
            logs = client.get_job_logs(job_id).replace(job_id, "<id>")
            client.delete_job(job_id)
            return (final, info["return_code"], info["metadata"],
                    info["entrypoint"].replace(key, "<key>"), logs,
                    os.path.exists(info["log_path"]))

        final, rc, metadata, _, logs, log_left = _both(case)
        assert (final, rc, metadata) == (status, code, {"who": "test"})
        assert logs == "job=<id>\nto-stderr\n" and not log_left

    def test_env_vars_reach_the_entrypoint(self, clusters):
        def case(package):
            client = _client(package)
            job_id = client.submit_job(
                entrypoint='echo "$GREETING"', submission_id=_job_id("env"),
                runtime_env={"env_vars": {"GREETING": "hi"}})
            client.wait_until_finish(job_id, timeout=TIMEOUT)
            return client.get_job_logs(job_id)

        assert _both(case) == "hi\n"

    def test_stop_a_running_job(self, clusters):
        def case(package):
            client = _client(package)
            job_id = client.submit_job(entrypoint="sleep 30",
                                       submission_id=_job_id("stop"))
            running = _wait_status(client, job_id, {"RUNNING"})
            stopped = client.stop_job(job_id)
            final = client.wait_until_finish(job_id, timeout=TIMEOUT)
            again = client.stop_job(job_id)  # nothing left to stop
            with pytest.raises(ValueError):
                client.stop_job("raysubmit_no_such_job")
            return (running, stopped, final,
                    client.get_job_info(job_id)["return_code"], again)

        assert _both(case) == ("RUNNING", True, "STOPPED", -15, False)

    def test_duplicates_and_listing(self, clusters):
        def case(package):
            client = _client(package)
            job_id = _job_id("dup")
            client.submit_job(entrypoint="true", submission_id=job_id)
            with pytest.raises(ValueError, match="already exists"):
                client.submit_job(entrypoint="true", submission_id=job_id)
            client.wait_until_finish(job_id, timeout=TIMEOUT)
            listed = {j["job_id"]: j["status"] for j in client.list_jobs()}
            with pytest.raises(ValueError, match="No job"):
                client.get_job_status("raysubmit_missing")
            return listed[job_id], sorted(listed.values()) == sorted(
                j["status"] for j in client.list_jobs())

        assert _both(case) == ("SUCCEEDED", True)

    def test_running_job_cannot_be_deleted(self, clusters):
        def case(package):
            client = _client(package)
            job_id = client.submit_job(entrypoint="sleep 30",
                                       submission_id=_job_id("del"))
            _wait_status(client, job_id, {"RUNNING"})
            with pytest.raises(RuntimeError, match="running"):
                client.delete_job(job_id)
            client.stop_job(job_id)
            return client.wait_until_finish(job_id, timeout=TIMEOUT)

        assert _both(case) == "STOPPED"


# -- the dashboard ----------------------------------------------------------

# The reference's metric names the port renames: TPU chips become GPUs.
METRIC_RENAMES = {"node_free_tpu_chips": "node_free_gpus"}


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=TIMEOUT) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _shape(value):
    """A JSON value's structure: a dict's keys, a list's first row's."""
    if isinstance(value, dict):
        return sorted(value)
    if isinstance(value, list):
        return ["list", _shape(value[0]) if value else None]
    return type(value).__name__


@pytest.fixture(scope="module")
def dashboards(clusters):
    ports = {package: _pkg(package, "dashboard").start_dashboard()
             for package in PACKAGES}
    try:
        yield ports
    finally:
        for package in PACKAGES:
            _pkg(package, "dashboard").stop_dashboard()


class TestDashboard:
    def test_the_same_endpoints_and_keys(self, dashboards):
        """Every JSON route answers in both, with the same keys (a task
        name carries its package: compared without it)."""
        routes = {package: sorted(_pkg(package, "dashboard")._routes())
                  for package in PACKAGES}
        assert routes["ray_tpu_torch"] == routes["ray_tpu"]
        assert len(routes["ray_tpu"]) == 15

        def case(package):
            out = {}
            for path in routes[package]:
                code, ctype, body = _get(dashboards[package], path)
                text = body.decode().replace("ray_tpu_torch", "ray_tpu")
                out[path] = (code, ctype, _shape(json.loads(text)))
            return out

        assert all(code == 200 for code, _, _ in _both(case).values())

    def test_cluster_status_reads_the_gpu_held(self, dashboards):
        """The port's cluster_status while an actor holds the (faked)
        GPU, and after it is gone."""
        import ray_tpu_torch as rt

        def status():
            return json.loads(_get(dashboards["ray_tpu_torch"],
                                   "/api/cluster_status")[2])

        holder = rt.remote(num_gpus=1)(Holder).remote()
        rt.get(holder.ping.remote(), timeout=TIMEOUT)
        during = status()
        rt.kill(holder)
        deadline = time.monotonic() + TIMEOUT
        while status()["resources_available"].get("GPU") != 1.0:
            assert time.monotonic() < deadline, status()
            time.sleep(0.05)
        assert during["resources_total"]["GPU"] == 1.0
        assert during["resources_available"]["GPU"] == 0.0
        assert during["nodes"] == 1

    def test_metrics_are_prometheus_text_with_the_same_names(self,
                                                             dashboards):
        def case(package):
            code, ctype, body = _get(dashboards[package], "/metrics")
            text = body.decode()
            types = re.findall(r"^# TYPE (\S+) (\w+)$", text, re.M)
            samples = [line for line in text.splitlines()
                       if line and not line.startswith("#")]
            assert all(re.match(r"^[a-zA-Z_:][\w:]*(\{[^}]*\})? \S+$", s)
                       for s in samples), samples
            names = {n for n, _ in types}
            assert {re.match(r"[\w:]+", s).group(0) for s in samples} <= {
                n + suffix for n in names
                for suffix in ("", "_bucket", "_sum", "_count")}
            if package == "ray_tpu":
                types = [(METRIC_RENAMES.get(n, n), t) for n, t in types]
            return code, ctype, sorted(types)

        code, ctype, types = _both(case)
        assert code == 200 and ctype.startswith("text/plain")
        assert len(types) > 5

    def test_html_page_and_errors(self, dashboards):
        for package in PACKAGES:
            code, ctype, body = _get(dashboards[package], "/")
            assert code == 200 and ctype == "text/html"
            assert f"<title>{package} dashboard</title>" in body.decode()
            assert _get(dashboards[package], "/api/nope")[0] == 404
        # a second start returns the running server's port
        assert _pkg("ray_tpu_torch", "dashboard").start_dashboard() == \
            dashboards["ray_tpu_torch"]


class Holder:
    def ping(self):
        return True


# -- AIR --------------------------------------------------------------------

def test_air_reexports_the_ports_train():
    """air's exports are Train's objects, the same names as ray_tpu.air,
    and air.session forwards to Train's and Tune's sessions."""
    from ray_tpu_torch import air, train
    from ray_tpu_torch.train import checkpoint, config, trainer

    assert sorted(air.__all__) == sorted(_pkg("ray_tpu", "air").__all__)
    assert air.Checkpoint is train.Checkpoint is checkpoint.Checkpoint
    assert air.CheckpointManager is checkpoint.CheckpointManager
    for name in ("CheckpointConfig", "FailureConfig", "RunConfig",
                 "ScalingConfig"):
        assert getattr(air, name) is getattr(config, name)
    assert air.Result is trainer.Result
    names = [n for n in dir(_pkg("ray_tpu", "air.session"))
             if not n.startswith("_")]
    assert all(hasattr(air.session, n) for n in names)
    with pytest.raises(RuntimeError, match="outside a tune trial"):
        air.session.report({"x": 1})
