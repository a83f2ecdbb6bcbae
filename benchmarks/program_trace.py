"""The program's own records of a traced window, on the trace's clock.

While a torch.profiler session is active the program keeps spans,
counts and device ranges in its process (``ray_tpu_torch.util.tracing``:
``local_records``, ``local_dropped``), each stamped with
``time.time_ns()``. After the window this module reads them, maps wall
ns onto the harness's ``perf_counter`` by ``time.time_ns() -
time.perf_counter_ns()`` (constant except across a clock step) and that
onto the trace by the harness's own marker alignment (the window's first
marker at the host's window start), keeps what lies inside the window,
and sums by name: host seconds and own seconds of spans, device ms of
ranges (forward and backward), counts. Idle gaps of the trace are
labelled by the innermost program span over them.

``read(ctx)`` gives None where the program keeps no such records (a
checkout from before them) or where any record of the window was
dropped; a metric then reports nothing.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from .trace import SHORT_GAP_S, merged

# The last reading, kept for the context it was made for: every metric
# of a run reads the same records.
_LAST: Dict = {}


class Program:
    """One window's records, in seconds on the host's ``perf_counter``
    clock (spans as (name, id, parent, start, end); ranges as (name,
    start, forward ms, backward ms or None); counts as (name, t, n)),
    with the offset that puts that clock onto the trace's."""

    def __init__(self, records: List[Dict], start: float, end: float,
                 wall_minus_perf_s: float, trace_offset_s: float):
        self.start, self.end = start, end
        self.offset = trace_offset_s
        shift = wall_minus_perf_s

        def host(ns):
            return ns / 1e9 - shift

        self.spans: List[Tuple[str, int, int, float, float]] = []
        self.ranges: List[Tuple[str, float, float, Optional[float]]] = []
        self.counts: List[Tuple[str, float, int]] = []
        for r in records:
            if r["kind"] == "span":
                self.spans.append((r["name"], r["id"], r["parent"],
                                   host(r["start_ns"]), host(r["end_ns"])))
            elif r["kind"] == "range":
                self.ranges.append((r["name"], host(r["start_ns"]),
                                    r["forward_ms"], r["backward_ms"]))
            else:
                self.counts.append((r["name"], host(r["ns"]), r["n"]))

    def _clip(self, a: float, b: float) -> float:
        return max(0.0, min(b, self.end) - max(a, self.start))

    def host_s(self, name: str) -> float:
        """Seconds of the spans ``name``, clipped to the window."""
        return sum(self._clip(a, b) for n, _, _, a, b in self.spans
                   if n == name)

    def spans_named(self, name: str) -> List[Tuple[float, float]]:
        """(start, end) of the spans ``name`` wholly inside the window."""
        return [(a, b) for n, _, _, a, b in self.spans
                if n == name and self.start <= a and b <= self.end]

    def exclusive_s(self, keep, without) -> float:
        """Seconds of the window covered by a span whose name ``keep``
        accepts and by none whose name ``without`` accepts: the former's
        own time, on whichever thread the latter run."""
        ours = merged([(max(a, self.start), min(b, self.end))
                       for n, _, _, a, b in self.spans
                       if keep(n) and self._clip(a, b) > 0])
        theirs = merged([(a, b) for n, _, _, a, b in self.spans
                         if without(n)])
        return sum(b - a for a, b in ours) - _overlap_s(ours, theirs)

    def device_ms(self, names, within: List[Tuple[float, float]] = None
                  ) -> Optional[float]:
        """Device ms (forward and backward) of the ranges named in
        ``names`` that start inside the window (or inside one of the
        ``within`` intervals); None when there is none."""
        total, seen = 0.0, False
        for name, t, fwd, bwd in self.ranges:
            if name not in names:
                continue
            if within is None:
                if not self.start <= t <= self.end:
                    continue
            elif not any(a <= t <= b for a, b in within):
                continue
            seen = True
            total += (fwd or 0.0) + (bwd or 0.0)
        return total if seen else None

    def count(self, name: str) -> int:
        return sum(n for c, t, n in self.counts
                   if c == name and self.start <= t <= self.end)

    def _innermost(self, t: float) -> Optional[str]:
        """The innermost program span over host time ``t``: of those that
        cover it, the one that started last."""
        best, start = None, None
        for name, _, _, a, b in self.spans:
            if a <= t <= b and (start is None or a > start):
                best, start = name, a
        return best

    def idle_gaps(self, trace, top: int = 10) -> List[List]:
        """[the innermost program span, idle seconds] for the device's
        gaps inside the window, summed by label, the largest first; gaps
        under SHORT_GAP_S are summed as launch spacing."""
        by_label: Dict[str, float] = {}
        for a, b in _gaps(trace):
            label = ("launch spacing (gaps under 20 us)"
                     if b - a < SHORT_GAP_S
                     else self._innermost(a - self.offset)
                     or "outside program spans")
            by_label[label] = by_label.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by_label.items(),
                                           key=lambda kv: -kv[1])][:top]

    def idle_under(self, trace, prefix: str) -> float:
        """Seconds of the trace's idle time inside the window during a
        span whose name starts with ``prefix``."""
        spans = merged([(a + self.offset, b + self.offset)
                        for n, _, _, a, b in self.spans
                        if n.startswith(prefix)])
        return _overlap_s(_gaps(trace), spans)


def _overlap_s(xs: List[Tuple[float, float]],
               ys: List[Tuple[float, float]]) -> float:
    """The length two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if lo < hi:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _gaps(trace) -> List[Tuple[float, float]]:
    """The trace's idle intervals inside its window, on its clock."""
    gaps, t = [], trace.start
    for a, b in merged(trace.device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if trace.end > t:
        gaps.append((t, trace.end))
    return gaps


def last_context():
    """The metric context of the last window read here (None before
    any): a traced run's, once one of its metrics read the records."""
    return _LAST.get("ctx")


def read(ctx) -> Optional[Program]:
    """The program's records of the window ``ctx`` describes, or None
    (no such records in this program, or a record of the window
    dropped)."""
    if _LAST.get("ctx") is ctx:
        return _LAST["program"]
    program = _read(ctx)
    _LAST.clear()
    _LAST.update(ctx=ctx, program=program)
    return program


def _read(ctx) -> Optional[Program]:
    try:
        from ray_tpu_torch.util import tracing
        local_records, local_dropped = (tracing.local_records,
                                        tracing.local_dropped)
    except (ImportError, AttributeError):
        return None
    w = ctx.window
    if not w.get("seconds"):
        return None
    shift = (time.time_ns() - time.perf_counter_ns()) / 1e9
    dropped, latest_ns = local_dropped()
    if dropped and latest_ns / 1e9 - shift >= w["start"]:
        return None
    return Program(local_records(), w["start"], w["end"], shift,
                   ctx.trace.start - w["start"])
