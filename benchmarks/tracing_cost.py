#!/usr/bin/env python3
"""What the program's hot-path records cost on a card, host and device.

    python3 benchmarks/tracing_cost.py

Prints one JSON line. Host microseconds a call (median of 7 rounds of
2,000 calls, tensors small enough that the card never holds the host
back): a plain ``rms_norm`` next to the same call as a device range
(``tracing.device_range``), forward alone and forward with backward
under autograd (also with host-ns stamps in place of events); one
identity node's backward stamping host ns, a timed event made there, or
one made beforehand; a hot span and a count; and
the pieces of a range (a timed CUDA event made and recorded, an
identity autograd node). Device
microseconds a range: the card's time for 250 short kernels queued
behind a sleep kernel (so the card, not the host, sets the pace), with a
range around each kernel against without, and the same for a timed
event alone.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _host_us(fn, calls: int = 2000, rounds: int = 7) -> float:
    import torch

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter_ns() - t0) / calls / 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def _device_us(step, n: int = 250, rounds: int = 5) -> float:
    """The card's microseconds a call, for ``n`` calls of ``step`` queued
    behind a sleep kernel long enough for the host to enqueue them all
    (few enough that they fit in the launch queue)."""
    import torch

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / n)
    return statistics.median(times)


def main() -> int:
    import torch

    from ray_tpu_torch.ops import layers
    from ray_tpu_torch.util import tracing

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    x = torch.randn(8, 768, device=dev, dtype=torch.bfloat16)
    w = torch.ones(768, device=dev, dtype=torch.bfloat16)
    xg = x.clone().requires_grad_(True)
    out = {"card": torch.cuda.get_device_name(dev)}
    norm = layers._rms_norm

    def ranged():
        tracing.device_range("model.norm", norm, x, w, 1e-6)

    def plain_grad():
        norm(xg, w, 1e-6).sum().backward()

    def ranged_grad():
        tracing.device_range("model.norm", norm, xg, w, 1e-6).sum() \
            .backward()

    def span():
        with tracing.local_span("s"):
            pass

    def event():
        torch.cuda.Event(enable_timing=True).record()

    mark = tracing._mark()
    rec = tracing._Range("r", 0, tracing._cuda_event)

    def node():
        mark.apply(rec, tracing._BWD0, xg)

    host = {
        "plain_forward": _host_us(lambda: norm(x, w, 1e-6)),
        "range_forward": _host_us(ranged),
        "plain_forward_backward": _host_us(plain_grad, calls=500),
        "range_forward_backward": _host_us(ranged_grad, calls=500),
        "hot_span": _host_us(span),
        "count": _host_us(lambda: tracing.local_count("c", 1)),
        "timed_event": _host_us(event),
        "identity_node": _host_us(node),
    }
    # The same range with host-ns stamps, no CUDA event: what the events
    # cost under autograd, against the identity nodes and the bookkeeping.
    real = tracing._stamper
    tracing._stamper = lambda cuda: tracing._now
    try:
        host["range_forward_backward_no_events"] = _host_us(ranged_grad,
                                                            calls=500)
    finally:
        tracing._stamper = real
    # One identity node whose backward records a timed event: made there
    # (as a range's backward does), or made beforehand on this thread and
    # only recorded there, against a host-ns stamp.
    made = []

    def premade():
        ev = made.pop()
        ev.record()
        return ev

    def node_backward(stamp):
        rec = tracing._Range("r", 0, stamp)
        return lambda: mark.apply(rec, tracing._BWD0, xg).sum().backward()

    host["node_backward_host_ns"] = _host_us(node_backward(tracing._now),
                                             calls=500)
    host["node_backward_event"] = _host_us(
        node_backward(tracing._cuda_event), calls=500)
    made.extend(torch.cuda.Event(enable_timing=True) for _ in range(3600))
    host["node_backward_premade_event"] = _host_us(node_backward(premade),
                                                   calls=500)
    tracing.clear_local()
    host["range_forward_cost"] = host["range_forward"] \
        - host["plain_forward"]
    host["range_forward_backward_cost"] = host["range_forward_backward"] \
        - host["plain_forward_backward"]
    out["host_us"] = host

    y = torch.zeros(256, device=dev)

    def kernel():
        y.add_(1.0)

    def ranged_kernel():
        tracing.device_range("k", lambda t: t.add_(1.0), y)

    def evented_kernel():
        y.add_(1.0)
        torch.cuda.Event(enable_timing=True).record()

    kernel_us = _device_us(kernel)
    out["device_us"] = {
        "kernel": kernel_us,
        "range_cost": _device_us(ranged_kernel) - kernel_us,
        "timed_event_cost": _device_us(evented_kernel) - kernel_us,
    }
    tracing.clear_local()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
