"""The device trace: capture with torch.profiler and reduce to numbers.

Frozen here for the benchmark: ``union_length``, ``overlap_share`` and
``kernel_group`` (the port's kernels, cuBLAS GEMMs, the optimizer and
the plain-torch glue by kernel name). Device busy time is the union of
the intervals of kernels, copies and memsets, never a sum of self times,
so work on two streams at once counts once.

The profiler records the card's activity alone (no host operators: their
cost slowed a host-paced window by a quarter). The traced window runs
from the marker kernel the harness launches as its measured loop starts
to the one it launches as the loop ends (``mark``); the harness's own
host spans, put on the trace's clock by the first marker, say what the
host was doing in each idle gap.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

# torch.profiler now and then hands back a trace that holds the host's
# runtime calls but no device event; such a trace is taken again, at most
# this many times in all.
TRACE_TAKES = 3
# The kernel ``torch.cuda._sleep`` launches: the window's two markers.
MARKER = "spin_kernel"
# The port's kernels by the name their trace events carry.
PORT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# The categories of a trace's events that ran on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GEMM_GROUP = "matmul (cuBLAS)"
OPTIMIZER_GROUP = "optimizer (AdamW)"
# Idle gaps shorter than this are launch spacing between kernels; they are
# summed under one label instead of being attributed one by one.
SHORT_GAP_S = 20e-6


def mark(device) -> None:
    """Launch the marker kernel that bounds a traced window (a spin of a
    cycle); nothing off the card."""
    if device.type == "cuda":
        import torch
        torch.cuda._sleep(1)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    """The disjoint (start, end) intervals that cover ``intervals``."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_share(copies, kernels) -> Optional[float]:
    """The share of the copies' time, (start, end) each, during which a
    kernel ran; None without copies."""
    copy_time = union_length(copies)
    if not copy_time:
        return None
    spans = merged(kernels)
    starts = [a for a, _ in spans]
    both = []
    for a, b in copies:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(spans) and spans[i][0] < b:
            lo, hi = max(a, spans[i][0]), min(b, spans[i][1])
            if lo < hi:
                both.append((lo, hi))
            i += 1
    return union_length(both) / copy_time


def kernel_group(name: str) -> str:
    """The group a device kernel's time is reported under."""
    low = name.lower()
    for kernel, group in (("flash_fwd", "K1 flash_fwd (this port)"),
                          ("flash_bwd_dq", "K2 flash_bwd_dq (this port)"),
                          ("flash_bwd_dkv", "K3 flash_bwd_dkv (this port)")):
        if kernel in low:
            return group
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return GEMM_GROUP
    if "multi_tensor" in low or "foreach" in low or "adam" in low:
        return OPTIMIZER_GROUP
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reductions"
    if "cat" in low or "copy" in low or "index" in low or "gather" in low \
            or "scatter" in low or "embedding" in low:
        return "copies and indexing"
    return "elementwise"


def port_kernel(name: str) -> Optional[str]:
    """K1-K3's name when ``name`` is one of the port's kernels."""
    for kernel in PORT_KERNELS:
        if kernel in name:
            return kernel
    return None


def capture(run: Callable[[], None]) -> "Trace":
    """Profile the card's activity during ``run()``, which must ``mark``
    its measured loop's start and end and end it in a device sync, and
    reduce the Chrome trace. The trace file lives in a temporary
    directory under TMPDIR and is removed once read. A trace with no
    device event is taken again over another ``run()``, at most
    TRACE_TAKES times in all."""
    from torch.profiler import ProfilerActivity, profile

    trace = None
    for _ in range(TRACE_TAKES):
        logdir = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
            path = os.path.join(logdir, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        trace = Trace(events)
        if trace.device:
            break
        print("the trace held no device event; taking it again",
              file=sys.stderr, flush=True)
    return trace


class Trace:
    """The numbers of one traced window, in seconds on the trace's
    clock."""

    def __init__(self, events: List[Dict]):
        def span(e) -> Tuple[float, float]:
            t = float(e["ts"]) * 1e-6
            return t, t + float(e.get("dur", 0)) * 1e-6

        device = [e for e in events if e.get("cat") in DEVICE_CATS
                  and "ts" in e]
        markers = sorted(span(e) for e in device if e.get("cat") ==
                         "kernel" and MARKER in e.get("name", ""))
        device = [e for e in device if MARKER not in e.get("name", "")]
        if len(markers) >= 2:
            self.start, self.end = markers[0][0], markers[-1][1]
        else:
            ts = [span(e) for e in device]
            self.start = min((a for a, _ in ts), default=0.0)
            self.end = max((b for _, b in ts), default=0.0)
        lo, hi = self.start, self.end

        def inside(evs):
            out = []
            for e in evs:
                a, b = span(e)
                a, b = max(a, lo), min(b, hi)
                if a < b:
                    out.append((a, b, e))
            return out

        dev = inside(device)
        self.device = [(a, b) for a, b, _ in dev]
        self.kernels = [(a, b, e.get("name", "")) for a, b, e in dev
                        if e.get("cat") == "kernel"]
        self.htod = [(a, b) for a, b, e in dev
                     if e.get("cat") == "gpu_memcpy"
                     and "HtoD" in e.get("name", "")]
        # The host's calls into the CUDA runtime (the profiler's runtime
        # activity; no host operators are recorded).
        calls = sorted((a, b, e.get("name", "")) for a, b, e in inside(
            [e for e in events if e.get("cat") == "cuda_runtime"
             and "ts" in e]))
        # The outermost of them: each not inside an earlier one.
        self.runtime: List[Tuple[float, float, str]] = []
        reach = -1.0
        for a, b, name in calls:
            if a >= reach:
                self.runtime.append((a, b, name))
            reach = max(reach, b)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return union_length(self.device)

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, keep: Callable[[str], bool]) -> float:
        """Summed duration of the kernels whose name ``keep`` accepts."""
        return sum(b - a for a, b, name in self.kernels if keep(name))

    def port_kernel_seconds(self) -> Dict[str, float]:
        out = {k: 0.0 for k in PORT_KERNELS}
        for a, b, name in self.kernels:
            k = port_kernel(name)
            if k:
                out[k] += b - a
        return out

    def htod_overlap_share(self) -> Optional[float]:
        return overlap_share(self.htod, [(a, b) for a, b, _ in self.kernels])

    def device_ops(self, top: int = 10) -> List[List]:
        """[group, seconds] of the device kernels, by kernel_group, the
        largest first (copies and memsets under their own names)."""
        groups: Dict[str, float] = {}
        for a, b, name in self.kernels:
            g = kernel_group(name)
            groups[g] = groups.get(g, 0.0) + (b - a)
        kernels = {(a, b) for a, b, _ in self.kernels}
        other = [(a, b) for a, b in self.device if (a, b) not in kernels]
        if other:
            groups["copies and memsets (non-kernel)"] = sum(
                b - a for a, b in other)
        return [[g, s] for g, s in sorted(groups.items(),
                                           key=lambda kv: -kv[1])][:top]

    def _host_label(self, t: float, spans: List, offset: float) -> str:
        """What the host was doing at trace time ``t``: the innermost of
        the harness's spans (host clock + ``offset`` = trace clock) and
        the CUDA runtime call that cover it."""
        span = "outside harness spans"
        latest = None
        for name, a, b in spans:
            if a + offset <= t <= b + offset and (latest is None
                                                  or a > latest):
                span, latest = name, a
        starts = [a for a, _, _ in self.runtime]
        i = bisect.bisect_right(starts, t) - 1
        call = "no CUDA call"
        if i >= 0 and self.runtime[i][1] >= t:
            call = self.runtime[i][2]
        return f"{span} / {call}"

    def idle_gaps(self, spans: List = (), host_start: float = 0.0,
                  top: int = 10) -> List[List]:
        """[what the host was doing, idle seconds] for the gaps in the
        device's work inside the window, summed by label, the largest
        first; gaps under SHORT_GAP_S are summed as launch spacing.
        ``spans`` are the harness's (name, start, end) on the host clock,
        whose ``host_start`` is the window's first marker."""
        offset = self.start - host_start
        gaps = []
        t = self.start
        for a, b in merged(self.device):
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        by_label: Dict[str, float] = {}
        for a, b in gaps:
            label = ("launch spacing (gaps under 20 us)"
                     if b - a < SHORT_GAP_S
                     else self._host_label(a, spans, offset))
            by_label[label] = by_label.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by_label.items(),
                                           key=lambda kv: -kv[1])][:top]
