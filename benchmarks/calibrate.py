#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell, on
the card at the cell's own size, in one process:

* the program's numbers over many seeds (the lower readings): training
  cells take the set-up's compared steps and no window; the batch cell a
  short window at its own load;
* the control's (the reference in the program's place, its products in
  float8: ``--control`` seeds), against the float32 reference;
* for a training cell, the program with half of each batch left out (the
  mean over the rest) on ``--faults`` seeds.

    python3 benchmarks/calibrate.py --workload <cell> --seeds 12 \
        --control 3 --faults 3 --out chiprun_out/calibrate.jsonl

Each reading is one JSON line in ``--out`` and on standard output. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def worst(program, reference, leaves=None):
    """The leaf with the widest gap, its gap and the median leaf's."""
    from benchmarks.compare import leaf_gaps

    gaps = leaf_gaps(program, reference, leaves)
    top = max(gaps, key=gaps.get)
    return {"leaf": top, "gap": gaps[top],
            "median_leaf_gap": statistics.median(gaps.values())}


def half_batch(family):
    """The family's train-step factory with each step given the first half
    of its batch's rows: the mean taken over the rest."""
    made = family.port_train_step

    def factory(c, device):
        init_state, step = made(c, device)

        def broken(state, batch):
            return step(state, tuple(x[:x.shape[0] // 2] for x in batch))
        return init_state, broken
    return made, factory


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--window", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--bench-dir", default=None,
                    help="a copy of the benchmark's data files (tests)")
    args = ap.parse_args(argv)
    import torch

    import ray_tpu_torch
    from benchmarks import compare, harness

    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    if device.type == "cuda":
        from ray_tpu_torch.ops import _kernels
        _kernels.build()
    ray_tpu_torch.init(local_mode=True, ignore_reinit_error=True)
    cell = harness.find_cell(args.workload,
                             args.bench_dir or harness.BENCH)
    module = harness.load_driver(cell)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "a")

    def emit(row):
        row.update(cell=cell.name, device=(torch.cuda.get_device_name(0)
                                           if device.type == "cuda"
                                           else "cpu"))
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    def fresh(seed):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return module.Driver(harness.Run(cell, seed, device,
                                         harness.Spans(),
                                         harness.peaks_of(device)))

    training = hasattr(module.Driver, "reference")
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        d = fresh(seed)
        d.setup()
        if not training:
            d.window(args.window)
        d.release()
        if training:
            ref = d.reference("float32")
            nums = compare.train_numbers(d.program, ref)
            nums.update(d.extra_numbers())
            row = {"kind": "program", "seed": seed, **nums,
                   "losses": d.program["losses"],
                   "ref_losses": ref["losses"],
                   "grad_worst": worst(d.program["g1"], ref["g1"]),
                   "update_worst": worst(d.program["d3"], ref["d3"],
                                         compare.moved_leaves(ref["g1"]))}
            if i < args.control:
                ctl = d.reference("fp8")
                cn = compare.train_numbers(ctl, ref)
                emit({"kind": "control_fp8", "seed": seed, **cn,
                      "losses": ctl["losses"],
                      "grad_worst": worst(ctl["g1"], ref["g1"]),
                      "update_worst": worst(ctl["d3"], ref["d3"],
                                            compare.moved_leaves(
                                                ref["g1"]))})
            if i < args.faults:
                saved, factory = half_batch(cell.family)
                cell.family.port_train_step = factory
                try:
                    f = fresh(seed)
                    f.setup()
                    f.release()
                finally:
                    cell.family.port_train_step = saved
                fn = compare.train_numbers(f.program, ref)
                emit({"kind": "fault_half_batch", "seed": seed, **fn,
                      "losses": f.program["losses"],
                      "grad_worst": worst(f.program["g1"], ref["g1"])})
                del f
        else:
            gaps = d.gaps("float32")
            row = {"kind": "program", "seed": seed, "logit_gap": max(gaps),
                   "row_gaps": gaps, "rows_served": len(d.served)}
            if i < args.control:
                cg = d.gaps("fp8")
                emit({"kind": "control_fp8", "seed": seed,
                      "logit_gap": max(cg), "row_gaps": cg})
        row["seconds"] = time.perf_counter() - t0
        emit(row)
        d.close()
        del d
    ray_tpu_torch.shutdown()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
