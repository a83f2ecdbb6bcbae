#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (``ray_tpu_torch``)
and a CUDA card. Set-up makes the inputs and weights from the seed,
builds the program's kernels (into ``ray_tpu_torch/_build/``, once a
checkout) and warms up the cell's shapes; then the window runs for
``--seconds`` seconds. With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
a torch.profiler trace of the window and the harness's own spans. After
the window the program's state is freed and the plain reference decides
``correct``; every number compared is printed beside its limit, as the
last lines on standard error and as the result's last key. The last
line of standard output is the result, one JSON object.

Exit codes: 0 with a result; 2 without a card (or with fewer than the
cell asks for); 3 when the program cannot be imported from the checkout;
4 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started, from /proc where it exists."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def _environment() -> None:
    """Caches at fixed paths inside the checkout, and no JAX pulled in by a
    library that would load it by itself."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench_dir: str = None, root: str = None
             ) -> dict:
    """One run of cell ``name`` on ``device``: set-up, window, the
    reference, the metrics. Returns the result line's object (``checks``
    last). Looks for no card: ``main`` does that."""
    import torch

    import ray_tpu_torch
    from benchmarks import harness
    from benchmarks import trace as tr

    bench_dir = bench_dir or harness.BENCH
    spec = harness.benchmark_spec(root or harness.ROOT)
    cell = harness.find_cell(name, bench_dir)
    run = harness.Run(cell, seed, device, harness.Spans(),
                      harness.peaks_of(device))
    phases = [("imports", time.perf_counter() - t_start)]
    if device.type == "cuda":
        from ray_tpu_torch.ops import _kernels
        _kernels.build()
    phases.append(("kernels", time.perf_counter() - t_start))
    ray_tpu_torch.init(local_mode=True, ignore_reinit_error=True)
    phases.append(("init", time.perf_counter() - t_start))
    driver = harness.load_driver(cell).Driver(run)
    try:
        driver.setup()
        harness.sync(device)
        setup_s = time.perf_counter() - t_start
        phases.append(("driver", setup_s))
        print("set-up, seconds from process start: " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases), file=sys.stderr, flush=True)
        holder = {}
        if trace:
            traced = tr.capture(lambda: holder.update(
                result=driver.window(seconds)))
        else:
            holder["result"] = driver.window(seconds)
        window = holder["result"]
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        driver.release()
        numbers = driver.numbers()
    finally:
        driver.close()
        ray_tpu_torch.shutdown()
    correct, checks = harness.judge(numbers, cell.workload["limits"])
    # An answer that came back wrong (a row with other than its tokens) is
    # as wrong as a number past its limit.
    correct = correct and window["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.workload["chips"] if device.type == "cuda" else 1,
           "memory_peak_bytes": int(peak)}
    metrics = {}
    out = {"correct": bool(correct), "attempted": int(window["attempted"]),
           "failed": int(window["failed"]), "metrics": metrics,
           "device": dev}
    if trace:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        ctx = harness.MetricContext(cell, run, window["info"], traced)
        for m in harness.metrics_for(spec, name, "per_layer"):
            value = harness.load_metric(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = {"device_ops": traced.device_ops(),
                            "idle_gaps": traced.idle_gaps(
                                run.spans.records, window["info"]["start"])}
    else:
        values = dict(window["e2e"], setup_s=setup_s)
        for m in harness.metrics_for(spec, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = _args(argv)
    _environment()
    try:
        import ray_tpu_torch
    except ImportError as e:
        print(f"the program cannot be imported from {ROOT}: {e}",
              file=sys.stderr)
        return 3
    where = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        print(f"ray_tpu_torch was found at {where}, outside the checkout "
              f"{ROOT}", file=sys.stderr)
        return 3
    import torch

    from benchmarks import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card and has no "
              "CPU fallback", file=sys.stderr)
        return 2
    chips = int(cell.workload["chips"])
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in this process: {loaded}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for key, c in result["checks"].items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
