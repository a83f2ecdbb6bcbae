"""The per-test time limit (tests/time_limit.py): each case runs a child
pytest with one xdist worker, as the tier-1 run has six, loading the
limit module, on a small test file whose tests wait forever, and reads
what the child reports."""

import os
import subprocess
import sys
import textwrap
import time
import xml.etree.ElementTree as ET

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

HEADER = """
import signal
import sys
import threading
import time

import pytest
"""

# id -> (the child's conftest, its test file, or a dict of test files by
# name, the outcome of each test, lines its output must hold); "error"
# is a teardown (or setup) error.
CASES = {
    "event_wait": ("", """
        @pytest.mark.time_limit(1)
        def test_hang():
            try:
                threading.Event().wait()
            except Exception:  # the cut is no Exception: this cannot hold it
                pass
        """, {"test_hang": "failed"}, []),
    "second_lock_acquire": ("", """
        @pytest.mark.time_limit(1)
        def test_hang():
            lock = threading.Lock()
            lock.acquire()
            lock.acquire()
        """, {"test_hang": "failed"}, []),
    "fixture_teardown": ("", """
        @pytest.fixture
        def stuck():
            yield
            threading.Event().wait()

        @pytest.mark.time_limit(1)
        def test_hang(stuck):
            pass
        """, {"test_hang": "error"}, []),
    "marker_sets_the_limit": ("", """
        @pytest.mark.time_limit(5)
        def test_longer():
            time.sleep(2)

        @pytest.mark.time_limit(1)
        def test_shorter():
            time.sleep(2)
        """, {"test_longer": "passed", "test_shorter": "failed"}, []),
    "next_test_not_held": ("", """
        @pytest.mark.time_limit(1)
        def test_hang():
            threading.Event().wait()

        def test_next():
            time.sleep(1.5)  # past the cut test's limit: its alarm is gone
        """, {"test_hang": "failed", "test_next": "passed"}, []),
    "names_test_phase_limit": ("", """
        @pytest.fixture
        def stuck_setup():
            threading.Event().wait()

        @pytest.fixture
        def stuck_teardown():
            yield
            threading.Event().wait()

        @pytest.mark.time_limit(1)
        def test_a(stuck_setup):
            pass

        @pytest.mark.time_limit(2)
        def test_b():
            threading.Event().wait()

        @pytest.mark.time_limit(3)
        def test_c(stuck_teardown):
            pass
        """, {"test_a": "error", "test_b": "failed", "test_c": "error"},
        ["test_child.py::test_a: setup passed its time limit of 1 s",
         "test_child.py::test_b: call passed its time limit of 2 s",
         "test_child.py::test_c: teardown passed its time limit of 3 s"]),
    "cluster_shut_down_after_cut": ("""
        import sys
        import threading
        import types

        import time_limit

        time_limit.SHUTDOWN_S = 1.0
        shutdowns = []
        for name, wedged in (("ray_tpu", True), ("ray_tpu_torch", False)):
            fake = types.ModuleType(name)
            fake.is_initialized = lambda: True
            fake.shutdown = ((lambda: threading.Event().wait()) if wedged
                             else (lambda: shutdowns.append(1)))
            sys.modules[name] = fake
        """, """
        @pytest.mark.time_limit(1)
        def test_hang():
            threading.Event().wait()

        def test_after():
            import conftest
            assert conftest.shutdowns == [1]
        """, {"test_hang": "failed", "test_after": "passed"},
        ["ray_tpu.shutdown() after the cut: TimeLimitExceeded: "
         "ray_tpu.shutdown() after the cut passed its time limit of 1 s"]),
    "file_boundary_clean_up": ("""
        import sys
        import types

        shutdowns = []
        fake = types.ModuleType("ray_tpu")
        fake.initialized = False
        fake.is_initialized = lambda: fake.initialized

        def shutdown():
            shutdowns.append("ray_tpu")
            fake.initialized = False

        fake.shutdown = shutdown
        serve = types.ModuleType("ray_tpu.serve")
        serve.shutdown = lambda: shutdowns.append("serve")
        telemetry = types.ModuleType("ray_tpu._private.telemetry")
        telemetry.enabled = True
        telemetry._env_enabled = lambda: True
        sys.modules.update({"ray_tpu": fake, "ray_tpu.serve": serve,
                            "ray_tpu._private.telemetry": telemetry})
        """, {"test_a_child.py": """
        def test_leaves_state():
            sys.modules["ray_tpu"].initialized = True
            sys.modules["ray_tpu._private.telemetry"].enabled = False

        def test_same_file():
            assert sys.modules["ray_tpu"].is_initialized()
        """, "test_b_child.py": """
        def test_next_file():
            import conftest
            assert conftest.shutdowns == ["serve", "ray_tpu"]
            assert not sys.modules["ray_tpu"].is_initialized()
            assert sys.modules["ray_tpu._private.telemetry"].enabled
        """}, {"test_leaves_state": "passed", "test_same_file": "passed",
               "test_next_file": "passed"}, []),
    "outside_its_directory": ("""
        import pathlib

        import time_limit

        time_limit.ONLY_UNDER = pathlib.Path("/nonexistent")
        """, """
        @pytest.mark.time_limit(1)
        def test_unlimited():
            time.sleep(2)
        """, {"test_unlimited": "passed"}, []),
    # A wait that never gives the interpreter the alarm: the backstop
    # ends the worker with every stack, and its replacement does not run
    # the test again.
    "backstop_ends_the_worker": ("""
        import time_limit

        time_limit.BACKSTOP_S = 1.0
        """, """
        @pytest.mark.time_limit(1)
        def test_blocked():
            signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGALRM])
            time.sleep(30)

        def test_after():
            pass
        """, {"test_blocked": "error", "test_after": "passed"},
        ["Timeout (0:00:02)!", "in test_blocked",
         "node down", "a worker ended while running this test"]),
}


def _outcomes(junit_path):
    out = {}
    for case in ET.parse(junit_path).getroot().iter("testcase"):
        kinds = {child.tag for child in case}
        # xdist records the ended worker's report and the rerun's setup
        # error as two cases of one name: the error is the later one.
        out[case.get("name")] = ("error" if "error" in kinds else
                                 "failed" if "failure" in kinds else
                                 "passed")
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_limit_cuts_alone(case, tmp_path):
    conftest, source, expected, lines = CASES[case]
    (tmp_path / "conftest.py").write_text(textwrap.dedent(conftest))
    files = source if isinstance(source, dict) else {"test_child.py": source}
    for name, text in files.items():
        (tmp_path / name).write_text(HEADER + textwrap.dedent(text))
    junit = tmp_path / "junit.xml"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(PYTHONPATH=TESTS, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    start = time.monotonic()
    child = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "time_limit",
         "-p", "no:cacheprovider", "-p", "xdist", "-n", "1",
         "--dist", "loadfile", f"--basetemp={tmp_path / 'base'}",
         f"--junitxml={junit}", *files],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    took = time.monotonic() - start
    output = child.stdout + child.stderr
    assert child.returncode == (set(expected.values()) != {"passed"}), output
    assert _outcomes(junit) == expected, output
    for line in lines:
        assert line in output, output
    # every cut came at its limit, not at the default 240 s
    assert took < 60, output
