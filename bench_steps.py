#!/usr/bin/env python3
"""Times the GPT-2-small and ViT-B/16 train steps of one checkout on the
card, for comparing two checkouts in one chip call (run it for each in
turns: parent, change, change, parent).

    python3 bench_steps.py [--root DIR]

imports ``ray_tpu_torch`` from DIR (default: the checkout holding this
script), builds its kernels, and prints one JSON line: for
``make_train_step(GPTConfig.gpt2_small())`` at B=16, S=1024 and
``make_vit_train_step(ViTConfig.vit_b16())`` at B=64, each with remat on
and off, chip_smoke.py's ``timed_steps`` (1 warm-up step, the median of
5 timed steps, each ended by fetching the loss; K1-K3 launches over one
step; ``max_memory_allocated`` over the timed steps), then one more step
traced by ``take_trace`` for its GEMM and K1-K3 kernel counts; with the
card's name and power limit. It exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

from chip_smoke import REPO, take_trace, timed_steps


def batch_of(family: str, cfg):
    """chip_smoke.py's batches: seed-0 tokens and their next tokens for
    GPT, seed-5 normal images and labels for ViT (phase_vit's)."""
    import numpy as np
    import torch

    if family == "gpt":
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (16, 1024), dtype=np.int64)
        return (torch.from_numpy(tokens).cuda(),
                torch.from_numpy(np.roll(tokens, -1, 1)).cuda())
    rng = np.random.default_rng(5)
    images = rng.standard_normal(
        (64, cfg.image_size, cfg.image_size, cfg.channels)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, 64, dtype=np.int64)
    return torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()


def step_row(family: str, remat: bool) -> dict:
    import torch

    from ray_tpu_torch.models import (GPTConfig, ViTConfig, make_train_step,
                                      make_vit_train_step)

    if family == "gpt":
        cfg = dataclasses.replace(GPTConfig.gpt2_small(), remat=remat)
        init_state, train_step = make_train_step(cfg)
    else:
        cfg = dataclasses.replace(ViTConfig.vit_b16(), remat=remat)
        init_state, train_step = make_vit_train_step(cfg)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    batch = batch_of(family, cfg)
    losses, steps_s, launches = timed_steps(train_step, state, batch)
    peak = torch.cuda.max_memory_allocated()
    traced = take_trace(lambda: (float(train_step(state, batch)[1]["loss"]),
                                 torch.cuda.synchronize()))
    del state, batch
    torch.cuda.empty_cache()
    return {"step_ms_median": statistics.median(steps_s) * 1e3,
            "step_ms_runs": [t * 1e3 for t in steps_s],
            "max_memory_allocated_gb": peak / 1e9, "losses": losses,
            "launches": launches, "gemm_launches": traced["gemm_launches"],
            "traced_kernels": traced["kernels"],
            "empty_traces": traced["empty_traces"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO,
                        help="checkout whose ray_tpu_torch is timed")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_steps: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from ray_tpu_torch.ops import _kernels

    if not os.path.abspath(_kernels.__file__).startswith(root + os.sep):
        print(f"bench_steps: imported {_kernels.__file__}, not {root}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {"root": args.root, "card": card, "torch": torch.__version__}
    for family in ("gpt", "vit"):
        for remat in (True, False):
            out[f"{family}_remat_{'on' if remat else 'off'}"] = \
                step_row(family, remat)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
