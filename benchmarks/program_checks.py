#!/usr/bin/env python3
"""How the program's own records agree with the trace of the same window.

    python3 benchmarks/program_checks.py --workload <cell> --seed <n> \
        [--seconds 10]

Runs the cell once as ``run.py --trace 1`` does and prints its result
line, then one line ``checks <JSON>``:

* ``idle_gaps``: the trace's idle gaps labelled by the innermost program
  span over them (``program_trace.Program.idle_gaps``).
* Training cells: ``phase_ms``, the device ms a step of the step's phase
  ranges (``train.forward``, ``train.backward``, ``train.optimizer``),
  and ``phases_over_busy``, their sum over the trace's busy ms a step. A
  range is stream time and includes any wait inside it, so it reads
  about 1. ``ranges_ms`` (the loss and pointwise metrics' sum) against
  ``glue_gemm_idle_ms`` (the glue metric, the GEMMs' and the idle time a
  step): a range covers the GEMMs and idle time inside it besides glue,
  so the former is no more than the latter.
* The fed cell: ``feed_idle_share`` against ``device_idle_share``, the
  share of the window idle under the feed's spans against all of it.
* Generation: ``padding_share`` against ``padding_from_lengths``, the
  share computed from the window's prompt lengths and its calls' buckets.

A program that keeps no records gives ``checks {}``. Exit codes as
``run.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import program_trace  # noqa: E402
from benchmarks.trace import GEMM_GROUP, kernel_group  # noqa: E402

PHASES = ("train.forward", "train.backward", "train.optimizer")


def _metric(metrics: Dict, prefix: str) -> Optional[float]:
    """The value of the one metric of the result named ``prefix.*``."""
    for name, m in metrics.items():
        if name.startswith(prefix + "."):
            return m["value"]
    return None


def padding_from_lengths(window: Dict) -> float:
    """1 - real positions / computed positions over the window's calls:
    at the k-th new token a row of prompt length L holds min(L + k,
    bucket) real positions of the bucket computed."""
    lengths = iter(window["lengths"])
    computed = real = 0
    for _, _, rows, bucket in window["calls"]:
        for _ in rows:
            length = next(lengths)
            for k in range(window["max_new_tokens"]):
                computed += bucket
                real += min(length + k, bucket)
    return 1.0 - real / computed


def checks(ctx, metrics: Dict) -> Dict:
    """The checks of one traced window (``ctx``, the metric context) and
    the per-layer metrics its result line holds."""
    p = program_trace.read(ctx)
    if p is None:
        return {}
    t, w = ctx.trace, ctx.window
    out: Dict = {"idle_gaps": p.idle_gaps(t)}
    steps = w.get("steps")
    if steps:
        phase_ms = {n: (p.device_ms((n,)) or 0.0) / steps for n in PHASES}
        busy_ms = 1e3 * t.busy_s / steps
        gemm_ms = 1e3 * t.kernel_seconds(
            lambda n: kernel_group(n) == GEMM_GROUP) / steps
        idle_ms = 1e3 * (t.window_s - t.busy_s) / steps
        out.update(phase_ms=phase_ms, busy_ms=busy_ms,
                   phases_over_busy=sum(phase_ms.values()) / busy_ms)
        glue = _metric(metrics, "glue_device_ms")
        ranges = [_metric(metrics, m) for m in ("loss_device_ms",
                                                "pointwise_device_ms")]
        ranges = [v for v in ranges if v is not None]
        if glue is not None and ranges:
            out.update(ranges_ms=sum(ranges),
                       glue_gemm_idle_ms=glue + gemm_ms + idle_ms)
    feed_idle = _metric(metrics, "feed_idle_share")
    if feed_idle is not None:
        out.update(feed_idle_share=feed_idle,
                   device_idle_share=_metric(metrics, "device_idle_share"))
    padding = _metric(metrics, "padding_share")
    if padding is not None and w.get("calls"):
        out.update(padding_share=padding,
                   padding_from_lengths=padding_from_lengths(w))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    from benchmarks import run

    run._environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    result = run.run_cell(args.workload, args.seed, args.seconds, True,
                          torch.device("cuda", 0), run.T_START)
    print(json.dumps(result), flush=True)
    ctx = program_trace.last_context()
    metrics = result["metrics"]
    print("checks " + json.dumps({} if ctx is None
                                 else checks(ctx, metrics)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
