"""Chaos / fault-injection test utilities.

Reference parity: python/ray/_private/test_utils.py:1512 —
ResourceKillerActor hierarchy (RayletKiller :1618, WorkerKillerActor
:1679) that kill components at intervals while a workload runs, driving
the chaos suites (python/ray/tests/test_chaos.py; SURVEY §4 tier 3).
Also what is left of a node daemon after it stopped: the live members of
its process group and the directories it stamped with its pid.
"""
import os
import signal
import threading
import time
from typing import List, Optional, Set

import ray_tpu_torch


class ResourceKiller:
    """Base interval-killer (reference: ResourceKillerActor). Runs as a
    plain thread in the driver (our raylet-equivalent state lives there;
    an actor could not SIGKILL its own host safely)."""

    def __init__(self, kill_interval_s: float = 0.5,
                 max_kills: int = 3, warmup_s: float = 0.2):
        self.kill_interval_s = kill_interval_s
        self.max_kills = max_kills
        self.warmup_s = warmup_s
        self.killed: List = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _find_victim(self):
        raise NotImplementedError

    def _kill(self, victim):
        raise NotImplementedError

    def run(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=type(self).__name__)
        self._thread.start()
        return self

    def _loop(self):
        time.sleep(self.warmup_s)
        while not self._stop.is_set() and len(self.killed) < self.max_kills:
            victim = self._find_victim()
            if victim is not None:
                try:
                    self._kill(victim)
                    self.killed.append(victim)
                except Exception:  # lint: broad-except-ok chaos kill racing natural process death; retry next tick
                    pass
            self._stop.wait(self.kill_interval_s)

    def stop(self) -> List:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        return list(self.killed)


class WorkerKiller(ResourceKiller):
    """SIGKILL busy worker processes (reference: WorkerKillerActor
    :1679 — validates task retry / actor restart paths)."""

    def __init__(self, target_actors: bool = False, **kw):
        super().__init__(**kw)
        self.target_actors = target_actors
        self._already: Set[int] = set()

    def _find_victim(self):
        from . import state
        rt = state.current_or_none()
        if rt is None:
            return None
        for handle in list(rt.pool.workers.values()):
            if handle.proc is None or handle.proc.pid in self._already:
                continue
            is_actor = handle.dedicated_actor is not None
            if is_actor != self.target_actors:
                continue
            if handle.running or is_actor:
                return handle.proc.pid
        return None

    def _kill(self, pid: int):
        self._already.add(pid)
        os.kill(pid, signal.SIGKILL)


def wait_for_condition(predicate, timeout: float = 10.0,
                       retry_interval_ms: float = 100.0, **kwargs) -> bool:
    """Reference: test_utils.py wait_for_condition."""
    deadline = time.monotonic() + timeout
    last_exc = None
    while time.monotonic() < deadline:
        try:
            if predicate(**kwargs):
                return True
        except Exception as e:  # noqa: BLE001
            last_exc = e
        time.sleep(retry_interval_ms / 1000.0)
    if last_exc:
        raise RuntimeError(
            f"wait_for_condition timed out; last error: {last_exc!r}")
    raise RuntimeError("wait_for_condition timed out")


def proc_stat(pid) -> List[str]:
    """Fields of /proc/<pid>/stat after the command name: the state
    first, the parent pid second, the process group third; [] once the
    process is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return []


def group_members(pgid: int) -> List[int]:
    """Live processes of the process group ``pgid``: a killed process is
    a zombie until its parent (or init) reaps it, and counts as gone."""
    out = []
    for name in os.listdir("/proc"):
        fields = proc_stat(name) if name.isdigit() else []
        if fields and fields[0] != "Z" and fields[2] == str(pgid):
            out.append(int(name))
    return sorted(out)


def owned_dirs(pid: int) -> List[str]:
    """This TMPDIR's session and store directories (a head's or a node
    daemon's, config.session_dirs) stamped with ``pid`` as their owner."""
    import glob

    from .config import session_dirs

    found = []
    for pattern in session_dirs("*"):
        for d in glob.glob(pattern):
            try:
                with open(os.path.join(d, ".owner_pid")) as f:
                    if int(f.read().strip()) == pid:
                        found.append(d)
            except (OSError, ValueError):
                pass
    return sorted(found)
