#!/usr/bin/env python3
"""Times the attention kernels of one checkout on the card, for comparing
two checkouts in one chip call (run it for each in turns: parent, change,
change, parent).

    python3 bench_kernels.py [--root DIR]

imports ``ray_tpu_torch`` from DIR (default: the checkout holding this
script), builds its kernels, and prints one JSON line: for each of
chip_smoke.py's two timed shapes (bf16, causal) the time of K1
(``flash_fwd``), K2 with delta = rowsum(dO * O) (``flash_bwd_dq``), K3
(``flash_bwd_dkv``), the whole backward through ``flash_attention``'s
autograd, and SDPA's forward as a yardstick, each timed by
chip_smoke.cuda_ms, with the card's name and power limit. A checkout
whose ``flash_bwd_dq`` takes delta instead of computing it is timed as
torch's delta followed by K2, so both forms are timed for the same work.
It exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import subprocess
import sys

from chip_smoke import GPT2_SHAPE, LLAMA_SHAPE, REPO, cuda_ms


def computes_delta(flash_bwd_dq) -> bool:
    """True if this ``flash_bwd_dq`` takes the forward's output o and
    computes delta itself; False if it takes delta from its caller."""
    params = inspect.signature(flash_bwd_dq).parameters
    return "o" in params and "delta" not in params


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO,
                        help="checkout whose ray_tpu_torch is timed")
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import flash_attention

    if not os.path.abspath(_kernels.__file__).startswith(root + os.sep):
        print(f"bench_kernels: imported {_kernels.__file__}, not {root}",
              file=sys.stderr)
        return 1
    _kernels.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    fused = computes_delta(_kernels.flash_bwd_dq)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": args.root, "card": card, "k2_computes_delta": fused}
    for shape in (GPT2_SHAPE, LLAMA_SHAPE):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        scale = 1.0 / math.sqrt(shape[-1])
        o, lse = _kernels.flash_fwd(q, k, v, True, scale, save_lse=True)
        delta = (do.float() * o.float()).sum(-1)

        def dq_with_delta():
            if fused:
                return _kernels.flash_bwd_dq(q, k, v, o, do, lse, True, scale)
            d = (do.float() * o.float()).sum(-1)
            return _kernels.flash_bwd_dq(q, k, v, do, lse, d, True, scale)

        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        attn = flash_attention(*leaves, True, scale)
        out["x".join(map(str, shape))] = {
            "flash_fwd_ms": cuda_ms(
                lambda: _kernels.flash_fwd(q, k, v, True, scale)),
            "flash_bwd_dq_with_delta_ms": cuda_ms(dq_with_delta),
            "flash_bwd_dkv_ms": cuda_ms(lambda: _kernels.flash_bwd_dkv(
                q, k, v, do, lse, delta, True, scale)),
            "flash_attention_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                attn, leaves, do, retain_graph=True)),
            "sdpa_fwd_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)),
        }
        del q, k, v, do, o, lse, delta, leaves, attn
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
