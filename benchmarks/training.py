"""The training cells' shared driver: one train-step object built at
set-up, driven through its first steps (the compared ones) and then
through the window, and the reference that follows those first steps.

A subclass says where the batches come from: ``start_data`` at set-up,
``next_batch`` for every step (the window's own call and feed), and
``reference_batch(k)``, the k-th batch as the harness made it, for the
reference.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from . import compare
from .harness import Run, make_params, sync
from .reference.common import MATMULS, AdamW, full_float32, leaves
from .trace import mark

BETA1 = 0.9   # the configuration's AdamW (reference/common.py's AdamW)


class TrainDriver:
    # The end-to-end metric the window's rate is reported as.
    RATE = "train_samples_per_s"

    def __init__(self, run: Run):
        self.run = run
        self.cell = run.cell
        self.p = run.cell.params
        self.fam = run.cell.family
        self.compared = int(self.p["compared_steps"])
        self.program: Dict = {}
        self.window_info: Dict = {}

    # -- to be given by the subclass --------------------------------------
    def start_data(self) -> None:
        raise NotImplementedError

    def next_batch(self):
        raise NotImplementedError

    def reference_batch(self, k: int):
        raise NotImplementedError

    def extra_numbers(self) -> Dict[str, float]:
        return {}

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        c, dev = self.cell.config, self.run.device
        params = make_params(self.fam.leaf_specs(c), self.run.seed, dev)
        init_state, self.train_step = self.fam.port_train_step(c, dev)
        self.state = init_state(params=params)
        self.start_data()
        named = leaves(self.state["params"])
        start = {n: t.detach().clone() for n, t in named}
        losses = []
        for k in range(self.compared):
            self.state, out = self.train_step(self.state, self.next_batch())
            losses.append(out["loss"])
            if k == 0:
                opt = self.state["opt_state"]
                self.program["g1"] = compare.leaf_norms(
                    (n, self._first_moment(opt, t) / (1 - BETA1))
                    for n, t in named)
        self.program["d3"] = compare.leaf_norms(
            (n, t.detach().float() - start[n].float()) for n, t in named)
        self.program["losses"] = [float(x) for x in losses]
        del start
        sync(dev)

    @staticmethod
    def _first_moment(opt, param: torch.Tensor) -> torch.Tensor:
        """The optimizer's first moment of ``param``; zeros where it kept
        none (a step that never reached the optimizer)."""
        st = opt.state.get(param, {}) if hasattr(opt, "state") else {}
        m = st.get("exp_avg")
        return torch.zeros_like(param) if m is None else m.float()

    # -- the window -------------------------------------------------------
    def window(self, seconds: float) -> Dict:
        spans, dev = self.run.spans, self.run.device
        batch = int(self.p["batch"])
        every = int(self.p["loss_every"])
        steps = 0
        sync(dev)
        t0 = time.perf_counter()
        mark(dev)
        while True:
            with spans.span("bench.step"):
                data = self.next_batch()
                self.state, out = self.train_step(self.state, data)
            steps += 1
            if steps % every == 0:
                with spans.span("bench.loss_fetch"):
                    float(out["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
        mark(dev)
        with spans.span("bench.sync"):
            sync(dev)
        t1 = time.perf_counter()
        samples = steps * batch
        self.window_info = {
            "start": t0, "end": t1, "seconds": t1 - t0, "steps": steps,
            "samples": samples,
            "step_flops": self.fam.train_flops(self.cell.config, self.p),
            "attention": self.fam.train_attention(self.cell.config, self.p),
        }
        return {"attempted": samples, "failed": 0,
                "e2e": {self.RATE: samples / (t1 - t0)},
                "info": self.window_info}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.train_step = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------
    def reference(self, matmul: str = "float32") -> Dict:
        """The reference's losses, first gradients and changes over the
        compared steps, from the same weights and batches, its products
        in ``matmul`` (``float32``, or ``fp8`` for the control)."""
        c, dev = self.cell.config, self.run.device
        specs = self.fam.leaf_specs(c)
        params = make_params(specs, self.run.seed, dev, dtypes=False)
        named = leaves(params)
        tensors = [t for _, t in named]
        start = [t.clone() for t in tensors]
        opt = AdamW(tensors, [getattr(torch, s[3]) for s in specs])
        out: Dict = {"losses": []}
        mm = MATMULS[matmul]
        with full_float32():
            for k in range(self.compared):
                loss, grads = self.fam.reference_loss_and_grads(
                    c, params, self.reference_batch(k), mm, tensors,
                    int(self.p["reference_rows"]))
                out["losses"].append(loss)
                if k == 0:
                    out["g1"] = compare.leaf_norms(
                        (n, g) for (n, _), g in zip(named, grads))
                opt.step(grads)
                del grads
        out["d3"] = compare.leaf_norms(
            (n, t - s) for (n, t), s in zip(named, start))
        return out

    def numbers(self) -> Dict[str, float]:
        ref = self.reference()
        out = compare.train_numbers(self.program, ref)
        out.update(self.extra_numbers())
        return out

    def close(self) -> None:
        pass
