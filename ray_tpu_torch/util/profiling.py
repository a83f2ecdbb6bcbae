"""Device profiling utilities (counterpart of the JAX package's
``util/profiling.py``, which wraps ``jax.profiler``; reference: the
nsight runtime-env plugin, _private/runtime_env/nsight.py, and the
per-function hooks in _private/profiling.py).

Here the profiler of record is ``torch.profiler``: a trace captures the
host's operators and, where a card is visible, its kernels and copies
(CUPTI), exported as a Chrome trace (Perfetto, chrome://tracing,
TensorBoard's profiler plugin). These helpers wrap it with the
framework's session layout and compose with remote tasks: each worker
process traces its own device work. torch is imported when a helper is
called, never with this module.
"""

from __future__ import annotations

import contextlib
import functools
import os
import socket
import time
from typing import Any, Callable, Dict, Optional


def default_logdir() -> str:
    """Session-scoped trace dir (driver) or one under the temp root."""
    from .._private import state
    from .._private.config import temp_root
    rt = state.current_or_none()
    base = getattr(rt, "session_dir", None) if rt is not None else None
    if base is None:
        base = os.path.join(temp_root(), "rtt_profiles")
    return os.path.join(base, "profiles")


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Context manager: capture a torch.profiler trace of the enclosed
    work (CPU activity, and CUDA activity whenever a card is visible) and
    export it as a Chrome trace into ``logdir``, named
    ``<host>_<pid>.<ns>.pt.trace.json``. Yields ``logdir``.

        with profiling.trace("/tmp/tb"):
            state, m = train_step(state, batch)
            float(m["loss"])
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or default_logdir()
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
        ".pt.trace.json"))


def profile(fn: Optional[Callable] = None, *,
            logdir: Optional[str] = None):
    """Decorator variant of `trace` for remote task/actor methods:

        @ray_tpu_torch.remote(num_gpus=1)
        @profiling.profile
        def step(batch): ...
    """
    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with trace(logdir):
                return f(*args, **kwargs)
        return wrapper
    return deco(fn) if fn is not None else deco


def device_memory_stats(device_index: int = 0) -> Dict[str, Any]:
    """Per-card memory stats under the keys JAX's ``Device.memory_stats``
    gives (reference: the dashboard's GPU memory reporter): from torch's
    caching allocator (``torch.cuda.memory_stats``) and the driver
    (``mem_get_info``). ``{}`` on a host without that card, as JAX's
    CPU backend may give."""
    import torch
    if not torch.cuda.is_available() \
            or device_index >= torch.cuda.device_count():
        return {}
    stats = torch.cuda.memory_stats(device_index)
    _, total = torch.cuda.mem_get_info(device_index)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        "peak_bytes_reserved": stats.get("reserved_bytes.all.peak", 0),
        "bytes_limit": total,
        "num_allocs": stats.get("allocation.all.allocated", 0),
    }


@contextlib.contextmanager
def annotate(name: str):
    """Named profiler span (reference: _private/profiling.profile): a
    ``torch.profiler.record_function`` region in the trace, and an NVTX
    range where a card is visible (for external CUDA profilers).

        with profiling.annotate("tokenize"): ...
    """
    import torch
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class Timer:
    """Lightweight wall-clock section timer for host-side code paths
    (reference: _private/profiling.py chrome-event helpers); records into
    the GCS span store so the timeline includes it, its ``ts`` in µs of
    ``time.time_ns()``, the clock of every other span and of a
    torch.profiler trace."""

    def __init__(self, name: str):
        self.name = name
        self.elapsed_s: Optional[float] = None

    def __enter__(self):
        self._t0_ns = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self._t0
        from .._private import state
        rt = state.current_or_none()
        gcs = getattr(rt, "gcs", None)
        if gcs is not None:
            gcs.record_spans([{
                "name": self.name, "cat": "profiling",
                "ts": self._t0_ns / 1e3, "dur": self.elapsed_s * 1e6,
                "pid": os.getpid(), "tid": 0, "ph": "X"}])
        return False
