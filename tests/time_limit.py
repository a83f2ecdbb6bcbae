"""A time limit on every phase of every test (setup, call, teardown).

A test that waits forever would hold its xdist worker, and the whole
run with it, until the run's own clock ends everything. Here each phase
runs under ``SIGALRM``: when its limit passes, the main thread, where
xdist runs tests, raises ``TimeLimitExceeded`` naming the test, the
phase and the limit, so the test fails alone and the next one starts.

A wait inside native code that never returns to the interpreter cannot
take the exception; ``faulthandler`` backs the alarm up: ``BACKSTOP_S``
after the limit it writes every thread's stack to the run's stderr and
ends the process (xdist then reports the worker down and replaces it).
Under ``--dist loadfile`` xdist hands the rest of the file, the test
that ended the worker included, to the new worker: a file left for each
running test in the run's temp directory stops that test from running,
and ending a worker, again.

After a cut, and after the last test of each file, whichever of
``ray_tpu`` and ``ray_tpu_torch`` is initialised is shut down, its Serve
first, under a short alarm of its own, and each package's telemetry switch is set back
to what its environment says. So a cluster that a cut left wedged, or
that a file's fixture left running, does not hold up or fail the tests
that come after it on the same worker.

The repo's root ``conftest.py`` loads it for the tests under ``tests/``;
a child pytest loads it with ``-p time_limit``.
"""

import contextlib
import faulthandler
import hashlib
import pathlib
import signal
import sys

import pytest

DEFAULT_S = 240.0
BACKSTOP_S = 60.0
SHUTDOWN_S = 30.0

# The tests measured above 80 s in whole runs on an 8-core CPU box,
# given as markers: three times their longest reading (in the comment),
# rounded up to a minute.
LIMITS_S = {
    "test_rllib.py::test_ppo_cartpole_learns": 900,  # 299.5 s
    "test_rllib.py::test_dqn_cartpole_smoke": 480,  # 145.1 s
    "test_rllib_catalog.py::TestImageTraining::test_ppo_image_env_trains":
        300,  # 99.1 s
    "test_torch_chip_smoke.py::TestCliClientPhase::test_phase_on_the_cpu":
        420,  # 125.8 s
    "test_torch_chip_smoke.py::TestMultinodePhase::test_phase_on_the_cpu":
        360,  # 100.9 s
}

# The directory whose tests run under the limit; None for every test.
ONLY_UNDER = None

_stderr_fd = None


class TimeLimitExceeded(BaseException):
    """A phase ran past its limit. A BaseException, as pytest's own
    outcomes are, so that a test's ``except Exception`` cannot hold it."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "time_limit(seconds): the limit of each phase of this test, in "
        f"place of the default {DEFAULT_S:g} s; only for tests measured "
        "above 80 s, at three times their time")
    global _stderr_fd
    # pytest has already pointed fd 2 into its capture file, which dies
    # with the process: the backstop writes to the copy of the old fd 2
    # that the capture keeps open for the session.
    capman = config.pluginmanager.getplugin("capturemanager")
    err = getattr(getattr(capman, "_global_capturing", None), "err", None)
    _stderr_fd = (getattr(err, "targetfd_save", None)
                  or sys.__stderr__.fileno())


def pytest_collection_modifyitems(items):
    for item in items:
        seconds = LIMITS_S.get(
            f"{item.path.name}::{item.nodeid.partition('::')[2]}")
        if seconds is not None:
            item.add_marker(pytest.mark.time_limit(seconds))


@contextlib.contextmanager
def _alarm(seconds, what):
    def cut(signum, frame):
        raise TimeLimitExceeded(
            f"{what} passed its time limit of {seconds:g} s")

    previous = signal.signal(signal.SIGALRM, cut)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + BACKSTOP_S, exit=True,
                                      file=_stderr_fd)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


def _clean_up(when):
    """Shut down an initialised ``ray_tpu`` or ``ray_tpu_torch``, its
    Serve first (whose driver-side proxy would outlive the cluster), and
    set each one's telemetry switch back to its environment's; returns a
    line for each shutdown that failed."""
    failures = []
    for name in ("ray_tpu", "ray_tpu_torch"):
        package = sys.modules.get(name)
        if package is not None and package.is_initialized():
            serve = sys.modules.get(f"{name}.serve")
            try:
                with _alarm(SHUTDOWN_S, f"{name}.shutdown() {when}"):
                    if serve is not None:
                        serve.shutdown()
                    package.shutdown()
            except (Exception, TimeLimitExceeded) as failed:
                failures.append(f"{name}.shutdown() {when}: "
                                f"{type(failed).__name__}: {failed}")
        telemetry = sys.modules.get(f"{name}._private.telemetry")
        if telemetry is not None:
            telemetry.enabled = telemetry._env_enabled()
    return failures


def _running_mark(item):
    """Under xdist, the file that stands for ``item`` while a worker runs
    it; one left behind names a test during which a worker ended."""
    if not hasattr(item.config, "workerinput"):
        return None
    run_dir = pathlib.Path(item.config.option.basetemp).parent
    return run_dir / ("running-"
                      + hashlib.sha1(item.nodeid.encode()).hexdigest())


def _limited(item, phase):
    marker = item.get_closest_marker("time_limit")
    seconds = float(marker.args[0]) if marker else DEFAULT_S
    try:
        with _alarm(seconds, f"{item.nodeid}: {phase}"):
            return (yield)
    except TimeLimitExceeded as cut:
        for line in _clean_up("after the cut"):
            cut.add_note(line)
        raise


def _in_scope(item):
    return ONLY_UNDER is None or ONLY_UNDER in item.path.parents


@pytest.hookimpl(wrapper=True, trylast=True)
def pytest_runtest_setup(item):
    if not _in_scope(item):
        return (yield)
    mark = _running_mark(item)
    if mark is not None:
        if mark.exists():
            pytest.fail(f"{item.nodeid}: a worker ended while running this "
                        "test (its stacks are in the run's log); it is not "
                        "run again", pytrace=False)
        mark.touch()
    return (yield from _limited(item, "setup"))


@pytest.hookimpl(wrapper=True, trylast=True)
def pytest_runtest_call(item):
    if not _in_scope(item):
        return (yield)
    return (yield from _limited(item, "call"))


@pytest.hookimpl(wrapper=True, trylast=True)
def pytest_runtest_teardown(item, nextitem):
    if not _in_scope(item):
        return (yield)
    try:
        return (yield from _limited(item, "teardown"))
    finally:
        mark = _running_mark(item)
        if mark is not None:
            mark.unlink(missing_ok=True)
        if nextitem is None or nextitem.path != item.path:
            for line in _clean_up(f"after {item.path.name}"):
                item.warn(pytest.PytestWarning(line))
