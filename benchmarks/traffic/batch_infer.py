"""Batch generation through the program's Data layer: rows of prompts made
from the seed, ``map_batches`` of a callable class around
``GPTInferenceStage`` (one pool actor under local mode), the window
pulling batches until its seconds are up.

Prompt lengths follow a log-normal of the workload's median and spread,
cut to the context (a prompt keeps at most ``seq - max_new_tokens``
tokens, so that it and its answer fit), taken at fixed quantiles: the
same set of lengths for every seed, in an order the seed shuffles. Ids
come from the real vocabulary.

The rate counts the rows of every stage call that ended inside the
window, whose end is the last batch pulled; set-up pulls the first batch
(which builds the stage) and calls the stage once at each other bucket
the traffic makes. The comparison takes a sample of the rows served,
drawn from the seed with the longest prompt among them, and holds each
served token to the reference's logits at that step.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import compare
from ..harness import Run, make_params, sub_seed, sync
from ..reference import gpt as ref
from ..reference.common import MATMULS, full_float32
from ..trace import mark

# The Data layer pickles a pool class's constructor arguments, so a stage
# finds the run's recorder by key. One entry a live run.
RECORDERS: Dict[str, "Recorder"] = {}


class Recorder:
    """What the harness sees of the stage: each call's span, rows and
    bucket, and the stage itself (for set-up's warm-up calls)."""

    def __init__(self, run: Run):
        self.run = run
        self.calls: List[tuple] = []   # (start, end, rows, bucket)
        self.stage = None


class TimedStage:
    """The pool actor: ``GPTInferenceStage`` on weights made from the seed,
    each call inside the harness's ``bench.stage_call`` span."""

    def __init__(self, key: str, max_new_tokens: int):
        from ray_tpu_torch.llm.batch import GPTInferenceStage

        self.rec = RECORDERS[key]
        run = self.rec.run
        c, fam = run.cell.config, run.cell.family
        params = make_params(fam.leaf_specs(c), run.seed, run.device)
        self.max_seq = fam.sizes(c)["seq"]
        self.stage = GPTInferenceStage(
            config=fam.port_config(c), params=params,
            max_new_tokens=max_new_tokens, input_column="tokens",
            output_column="generated", device=run.device)
        self.rec.stage = self

    def __call__(self, batch: Dict) -> Dict:
        bucket = ref.stage_bucket([len(t) for t in batch["tokens"]],
                                  self.max_seq)
        t0 = time.perf_counter()
        with self.rec.run.spans.span("bench.stage_call"):
            out = self.stage(batch)
        self.rec.calls.append((t0, time.perf_counter(),
                               [int(r) for r in batch["row"]], bucket))
        return out


def prompt_lengths(n: int, median: float, sigma: float, cap: int
                   ) -> np.ndarray:
    """``n`` lengths at the quantiles of a log-normal of ``median`` and
    ``sigma`` (of the log), each cut to [1, cap]: the same set for every
    seed."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.round(median * np.exp(sigma * z))
    return np.clip(lengths, 1, cap).astype(np.int64)


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.cell = run.cell
        self.p = run.cell.params
        self.fam = run.cell.family
        self.key = f"{id(self)}"
        self.window_info: Dict = {}
        self.served: Dict[int, np.ndarray] = {}

    def setup(self) -> None:
        from ray_tpu_torch import data

        p, seed = self.p, self.run.seed
        s = self.fam.sizes(self.cell.config)
        n, batch = int(p["rows"]), int(p["batch"])
        rng = np.random.default_rng(sub_seed(seed, "prompts"))
        cap = s["seq"] - int(p["max_new_tokens"])
        lengths = rng.permutation(prompt_lengths(
            n, float(p["prompt_median"]), float(p["prompt_sigma"]), cap))
        self.prompts = [rng.integers(0, s["real_vocab"], size=int(m),
                                     dtype=np.int64) for m in lengths]
        self.buckets = [ref.stage_bucket(
            [len(t) for t in self.prompts[i:i + batch]], s["seq"])
            for i in range(0, n, batch)]
        RECORDERS[self.key] = self.rec = Recorder(self.run)
        ds = data.from_items(
            [{"row": i, "tokens": t} for i, t in enumerate(self.prompts)],
            override_num_blocks=math.ceil(n / batch))
        gpus = 1 if self.run.device.type == "cuda" else None
        self.pipe = ds.map_batches(
            TimedStage, batch_size=batch, concurrency=1, num_gpus=gpus,
            fn_constructor_kwargs={"key": self.key,
                                   "max_new_tokens": int(
                                       p["max_new_tokens"])})
        self.iterator = iter(self.pipe.iter_batches(batch_size=None))
        self._take(next(self.iterator))
        # One call at each other bucket the traffic makes, outside the
        # pipeline, so that no shape is first seen in the window.
        first = self.rec.calls[0][3]
        for b in sorted(set(self.buckets) - {first}):
            i = self.buckets.index(b) * batch
            rows = list(range(i, min(i + batch, n)))
            tokens = np.empty(len(rows), object)
            for j, r in enumerate(rows):
                tokens[j] = self.prompts[r]
            self.rec.stage({"row": np.array(rows), "tokens": tokens})
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def _take(self, out: Dict) -> None:
        for r, toks in zip(out["row"], out["generated"]):
            self.served[int(r)] = np.asarray(toks)

    def window(self, seconds: float) -> Dict:
        spans = self.run.spans
        dev = self.run.device
        sync(dev)
        t0 = time.perf_counter()
        mark(dev)
        while time.perf_counter() - t0 < seconds:
            with spans.span("bench.pull"):
                out = next(self.iterator, None)
            if out is None:
                raise RuntimeError(
                    "the cell's rows ran out before the window closed; "
                    "give the workload more rows")
            self._take(out)
        mark(dev)
        sync(dev)
        t1 = time.perf_counter()
        calls = [c for c in self.rec.calls if c[0] >= t0 and c[1] <= t1]
        rows = sum(len(c[2]) for c in calls)
        want = int(self.p["max_new_tokens"])
        # A row computed ahead of the last pull is judged when pulled; one
        # pulled with other than max_new_tokens tokens failed.
        failed = sum(1 for c in calls for r in c[2] if r in self.served
                     and self.served[r].shape != (want,))
        self.window_info = {
            "start": t0, "end": t1, "seconds": t1 - t0, "rows": rows,
            "calls": calls, "max_new_tokens": want,
            "lengths": [len(self.prompts[r]) for c in calls for r in c[2]],
        }
        return {"attempted": rows, "failed": failed,
                "e2e": {"infer_rows_per_s": rows / (t1 - t0)},
                "info": self.window_info}

    def release(self) -> None:
        """Stop the pipeline and free the stage's weights."""
        if self.iterator is not None:
            close = getattr(self.iterator, "close", None)
            if close is not None:
                close()
        self.iterator = self.pipe = None
        RECORDERS.pop(self.key, None)
        self.rec.stage = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """The compared rows: ``sample_rows`` of the served ones, drawn
        from the seed, with the longest prompt served among them."""
        rows = sorted(self.served)
        longest = max(rows, key=lambda r: (len(self.prompts[r]), -r))
        rng = np.random.default_rng(sub_seed(self.run.seed, "sample"))
        rest = [r for r in rows if r != longest]
        k = min(int(self.p["sample_rows"]) - 1, len(rest))
        return [longest] + sorted(int(x) for x in rng.choice(
            rest, size=k, replace=False))

    def gaps(self, matmul: str = "float32") -> List[float]:
        """Per sampled row, the widest gap of a served token below the
        reference's best logit; with ``fp8`` the control's reading: at
        the same windows, the gap of the token the float8 reference puts
        first."""
        c, dev = self.cell.config, self.run.device
        s = self.fam.sizes(c)
        batch = int(self.p["batch"])
        params = make_params(self.fam.leaf_specs(c), self.run.seed, dev,
                             dtypes=False)
        out = []
        with torch.no_grad(), full_float32():
            for r in self.sample():
                served = torch.as_tensor(self.served[r], device=dev).long()
                windows = ref.stage_windows(
                    torch.as_tensor(self.prompts[r], device=dev), served,
                    self.buckets[r // batch], s["vocab"])
                logits = ref.last_logits(params, windows, s["heads"],
                                         MATMULS["float32"])
                chosen = served
                if matmul != "float32":
                    chosen = ref.last_logits(params, windows, s["heads"],
                                             MATMULS[matmul]).argmax(-1)
                out.append(float(compare.logit_gaps(logits, chosen).max()))
        return out

    def numbers(self) -> Dict[str, float]:
        gaps = self.gaps()
        return {"logit_gap": max(gaps) if gaps else float("inf")}

    def close(self) -> None:
        RECORDERS.pop(self.key, None)
