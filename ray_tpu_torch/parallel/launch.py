"""Ranks as processes on one host.

JAX drives every device of a mesh from one controller; the port's mesh
is a ``torch.distributed`` world of processes, one device a rank.
``RankPool(world, device)`` starts ``world`` Python processes (``python
-m ray_tpu_torch.parallel.launch``), each one rank of a gloo world on
localhost with one intra-op thread, and keeps them for many calls:
``pool.run(fn, *args)`` calls ``fn(*args)`` in every rank and returns
the results in rank order.

``device`` is resolved as every entry point's is (``None``: the card).
On the card every rank is on ``cuda:0``: ranks that share one card talk
gloo (NCCL takes one rank a GPU), with the CUDA tensors that gloo does
not take staged through host memory by ``parallel.ops``. ``"cpu"``
runs the ranks on the CPU.

``fn`` goes by reference: a top-level function of a module the ranks can
import (the caller's ``sys.path`` is theirs). A rank's exception, or a
call that outlives its deadline, closes the pool (every rank killed) and
raises in the caller, so a rank stuck in a collective never hangs it.
"""

from __future__ import annotations

import os
import secrets
import socket
import subprocess
import sys
import threading
import time
import traceback
from datetime import timedelta
from multiprocessing.connection import Client, Listener, wait
from typing import Any, Callable, List, Optional

from .._device import DeviceLike, resolve_device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    """``world`` rank processes of one gloo world (see the module
    docstring). Close it (or use it as a context manager)."""

    def __init__(self, world: int, device: DeviceLike = None,
                 timeout: float = 120.0):
        device = resolve_device(device).type
        self.world, self.device, self.timeout = world, device, timeout
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        host, port = self._listener.address
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in sys.path if p))
        store = free_port()
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.parallel.launch", host,
             str(port), key.hex(), str(rank), str(world), str(store),
             device, str(timeout)], env=env)
            for rank in range(world)]
        self._conns: List[Any] = [None] * world
        accepted: List[Any] = []

        def accept():
            try:
                for _ in range(world):
                    accepted.append(self._listener.accept())
            except OSError:
                pass  # the listener closed: the deadline passed

        thread = threading.Thread(target=accept, daemon=True)
        thread.start()
        thread.join(timeout)
        if len(accepted) < world:
            self.close(kill=True)
            raise TimeoutError(f"{len(accepted)} of {world} ranks started "
                               f"in {timeout} s")
        try:
            for conn in accepted:
                rank = self._recv(conn, time.monotonic() + timeout)
                self._conns[rank] = conn
        except BaseException:
            self.close(kill=True)
            raise

    def _recv(self, conn, deadline: float):
        if not conn.poll(max(0.0, deadline - time.monotonic())):
            raise TimeoutError("a rank did not answer in time")
        ok, value = conn.recv()
        if not ok:
            raise RuntimeError(f"a rank failed:\n{value}")
        return value

    def run(self, fn: Callable, *args, timeout: Optional[float] = None
            ) -> list:
        """``fn(*args)`` in every rank; the results in rank order."""
        if any(c is None for c in self._conns):
            raise RuntimeError("the pool is closed")
        for conn in self._conns:
            conn.send((fn, args))
        deadline = time.monotonic() + (timeout or self.timeout)
        results: List[Any] = [None] * self.world
        pending = {conn: rank for rank, conn in enumerate(self._conns)}
        try:
            while pending:
                ready = wait(list(pending),
                             max(0.0, deadline - time.monotonic()))
                if not ready:
                    raise TimeoutError(
                        f"{getattr(fn, '__name__', fn)}: ranks "
                        f"{sorted(pending.values())} did not finish in "
                        f"{timeout or self.timeout} s")
                for conn in ready:
                    rank = pending.pop(conn)
                    ok, value = conn.recv()
                    if not ok:
                        raise RuntimeError(
                            f"{getattr(fn, '__name__', fn)} failed on rank "
                            f"{rank}:\n{value}")
                    results[rank] = value
        except BaseException:
            self.close(kill=True)
            raise
        return results

    def close(self, kill: bool = False) -> None:
        """End every rank: asked to leave, or (``kill``, after a failure,
        when a rank may be stuck in a collective) killed at once."""
        for conn in self._conns:
            if conn is not None:
                try:
                    conn.send(None)
                except OSError:
                    pass
        self._conns = [None] * self.world
        for proc in self._procs:
            if kill:
                proc.kill()
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._listener.close()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _serve(host: str, port: int, key: bytes, rank: int, world: int,
           store: int, device: str, timeout: float) -> None:
    import torch
    import torch.distributed as dist

    conn = Client((host, port), authkey=key)
    try:
        # The ranks share the host's cores.
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{store}", rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout))
    except BaseException:
        conn.send((False, traceback.format_exc()))
        raise
    conn.send((True, rank))
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args = msg
            try:
                conn.send((True, fn(*args)))
            except BaseException:
                conn.send((False, traceback.format_exc()))
    except EOFError:
        pass  # the pool went away
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _h, _p, _k, _r, _w, _s, _d, _o = sys.argv[1:9]
    _serve(_h, int(_p), bytes.fromhex(_k), int(_r), int(_w), int(_s), _d,
           float(_o))
