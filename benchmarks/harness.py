"""What every cell shares: finding a cell's files by name, seeds, weights
made from the seed on the device, host spans, the comparison's verdict,
and the result line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``), whose ``family`` names
``families/<family>.py``, and its traffic driver (``traffic/<driver>.py``).
Per-layer metrics are ``metrics/<metric>.py``, each found by the name
BENCHMARK.json gives it. Adding a cell, a configuration or a metric is
adding files.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Tuple

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package the program was ported from. Compared whole, so the program's
# own ``ray_tpu_torch`` is not among them.
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def metrics_for(spec: Dict, cell: str, kind: str) -> List[Dict]:
    """The entries of ``spec[kind]`` (``end_to_end`` or ``per_layer``)
    that the cell reports: those that list it, or that list no cells."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    family: Any

    @property
    def params(self) -> Dict:
        return self.workload["params"]


def find_cell(name: str, bench_dir: str = BENCH) -> Cell:
    """The cell called ``name``: its workload file, its configuration and
    its family module. Raises FileNotFoundError for an unknown name."""
    workload = load_json(os.path.join(bench_dir, "workloads",
                                      f"{name}.json"))
    config = load_json(os.path.join(bench_dir, "configs",
                                    f"{workload['config']}.json"))
    family = importlib.import_module(f"benchmarks.families."
                                     f"{config['family']}")
    return Cell(name, workload, config, family)


def load_driver(cell: Cell):
    """The traffic driver module the cell names."""
    return importlib.import_module(
        f"benchmarks.traffic.{cell.workload['traffic']}")


def load_metric(name: str, bench_dir: str = BENCH) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmarks_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def sub_seed(seed: int, *tags: str) -> int:
    """A 63-bit seed for one purpose, from the run's seed."""
    digest = hashlib.sha256(":".join([str(seed), *tags]).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_params(specs: List, seed: int, device, dtypes: bool = True
                ) -> Dict:
    """Weights from ``specs`` ((path, shape, init, dtype) in the program's
    layout), drawn on ``device`` from ``seed`` in one call: a flat normal
    draw cut into the leaves, each scaled by its std. With ``dtypes`` each
    leaf is in its stated dtype; without, every leaf is float32 holding
    the same values."""
    import math

    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    drawn = [s for s in specs if not isinstance(s[2], str)]
    total = sum(math.prod(s[1]) for s in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = [], 0
    for path, shape, init, dtype in specs:
        dt = getattr(torch, dtype)
        if init == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dt, device=device)
        else:
            n = math.prod(shape)
            t = (flat[offset:offset + n].view(shape) * init).to(dt)
            offset += n
        out.append((path, t if dtypes else t.float()))
    del flat
    return tree_from_paths(out)


def tree_from_paths(items: List[Tuple[str, Any]]) -> Dict:
    """Nested dicts and lists from (dotted path, leaf); a numeric part of
    a path is a list index."""
    root: Dict = {}
    for path, leaf in items:
        parts = path.split(".")
        node: Any = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            key = int(part) if isinstance(node, list) else part
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if nxt.isdigit() else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if nxt.isdigit() else {})
        last = parts[-1]
        if isinstance(node, list):
            while len(node) <= int(last):
                node.append(None)
            node[int(last)] = leaf
        else:
            node[last] = leaf
    return root


class Spans:
    """The harness's own host spans: (name, start, end) by perf_counter."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str, start: float, end: float) -> float:
        """Seconds of the spans called ``name`` inside [start, end]."""
        return sum(max(0.0, min(b, end) - max(a, start))
                   for n, a, b in self.records if n == name)

    def count(self, name: str, start: float, end: float) -> int:
        return sum(1 for n, a, b in self.records
                   if n == name and a >= start and b <= end)


def forbidden_modules() -> List[str]:
    """The modules of FORBIDDEN that this process has loaded, by their
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict]]:
    """Each compared number against its limit (a number passes at or
    under it; one that is not finite fails): the verdict and, by name,
    each number beside its limit."""
    import math

    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver is handed."""
    cell: Cell
    seed: int
    device: Any
    spans: Spans
    peaks: Dict


def peaks_of(device) -> Dict:
    from .flops import peaks_for

    if device.type != "cuda":
        return peaks_for("")
    import torch
    return peaks_for(torch.cuda.get_device_name(device))


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reads: the cell, the run (spans, peaks),
    the driver's account of the window, and the trace of that window."""
    cell: Cell
    run: Run
    window: Dict
    trace: Any
