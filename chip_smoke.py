#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the port's kernels from ``ray_tpu_torch/ops/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
drives the port's serving paths and its train step at GPT-2-small width,
and prints one JSON line per phase:

  1. device         the card (nvidia-smi name and power limit), torch, CUDA
  2. build          kernel build seconds and ptxas's register, spill and
                    shared-memory report per kernel, with its performance
                    notes (wgmma serialised, setmaxnreg ignored), and each
                    kernel's design read from its machine code; fails if
                    a bf16 kernel spills or a bf16 K1, K2 or K3 is not
                    wgmma+tma. The full compiler output and the machine
                    code go to ray_tpu_torch/_build/build_log.txt and
                    sass.txt
  3. compare        flash_fwd (K1) vs mha_reference at the test and model
                    shapes and at the edges of its 128-row and 128-key
                    tiles (S = 127, 129, 255, 257; B*H = 1; more blocks
                    than SMs), with its lse; kernel, plain and SDPA times
                    at the two model shapes
  4. compare_bwd    flash_bwd_dq (K2) and flash_bwd_dkv (K3), through the
                    autograd backward of flash_attention, vs
                    flash_bwd_reference, and that reference vs autograd
                    through mha_reference, at the same shapes; the delta
                    K2 writes vs rowsum(dO * O); K2 and K3 each called
                    twice on the same inputs (K3 on K2's delta) must give
                    bit-identical outputs; kernel, plain, whole-backward
                    and SDPA-backward times at the two model shapes
  5. slice          GPTInferenceStage (the batch serving path that runs
                    K1): 16 prompts bucketed to T=1024, 8 greedy steps,
                    K1's launches counted over exactly that run; its
                    first-step logits against the port on the CPU
  6. online         LLMEngine and ContinuousBatchingEngine at GPT-2-small
                    width: time to first token, decode tokens/s, and the
                    KV-cache logits against a full forward
  7. train          make_train_step(GPTConfig.gpt2_small()) at B=16,
                    S=1024, bf16, remat on (the preset) and off: step ms,
                    tokens/s, MFU, peak memory, the losses, and K1, K2, K3
                    launches counted over exactly one step
  8. train_vs_cpu   one step at GPT-2-small width and 2 layers, card vs
                    CPU from the same weights: loss, every gradient, every
                    param after AdamW (f32 at T=128, bf16 at ragged T=100)
  9. train_profile  torch.profiler over one train step: device ms by
                    group (K1, K2, K3 each a group) and the idle share
 10. kernels        one entry per kernel: launches, error, times and bound
                    at both timed shapes, and its design

and, as its last line, {"ok": true, "device": {...}}. Any failed phase or
comparison raises, so the script exits non-zero without the last line.
Without a CUDA card, or without the repository around it, it exits
non-zero at once.

Numbers here are measured on the card of this run; write them down with
the card's name and power limit printed in phase 1.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances (kernel vs plain version, same inputs on the card):
# f32: the kernel sums the online softmax in another order than the plain
#   version's one-pass softmax; no TF32 on either side.
TOL_F32_ABS = 2e-3
# bf16, after dividing by max|ref|: P is rounded to bf16 before the PV
#   product in both, but at different points of the sum (per tile vs once).
TOL_BF16_NORM = 2e-2
# lse (f32) vs logsumexp of the plain f32 logits: the same products summed
#   in another order, and the kernel's fast exp.
TOL_LSE_ABS = 1e-3
# Backward kernels (K2, K3) vs flash_bwd_reference, after dividing by
#   max(1, max|ref|): f32 takes the JAX package's own band for its kernel
#   gradients (tests/test_models_ops.py); bf16 rounds P and dS to bf16 in
#   both, but a P or dS within rounding of a bf16 step can round the other
#   way (the kernel's exp is the fast one), and each gradient is rounded
#   to bf16 once: a few ulps of bf16 (2**-8 = 3.9e-3).
TOL_BWD_F32_NORM = 6e-3
TOL_BWD_BF16_NORM = 1e-2
# delta = rowsum(dO * O) from K2 vs the same sum in torch, over the row's
#   sum of |dO * O| (delta can cancel, so the band is not taken against
#   delta itself): the products are the same (exact in f32 for bf16
#   inputs), summed in another order.
TOL_DELTA = 1e-5
# flash_bwd_reference vs autograd through mha_reference, both f32, after
#   dividing by max|ref|: the same products, the softmax through lse
#   instead of its own normalization.
TOL_BWD_REF_NORM = 1e-4
# Model logits through 12 bf16 layers, card vs CPU or cached vs full
#   forward, after dividing by max|ref|: every matmul output is rounded to
#   bf16 on both sides, at different points (bf16 vs f32 of the same
#   weights differ by ~1.1e-2 on the port's CPU path).
TOL_MODEL_NORM = 3e-2

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s,
# f32 non-tensor FLOP/s, HBM bytes/s. Matched on the nvidia-smi name.
PEAKS = [
    ("H100 PCIe", {"bf16": 756e12, "f32": 51e12, "bytes": 2.0e12}),
    ("H100 NVL", {"bf16": 835e12, "f32": 60e12, "bytes": 3.9e12}),
    ("H200", {"bf16": 989e12, "f32": 67e12, "bytes": 4.8e12}),
    ("H100", {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12}),  # SXM
]


# The two timed shapes: the GPT-2-small train and serving shape, and the
# llama bench shape (LlamaConfig.tpu_bench() at B=8).
GPT2_SHAPE, LLAMA_SHAPE = (16, 12, 1024, 64), (8, 8, 2048, 128)

# A kernel's design, from the tensor-core and copy instructions in its
# machine code (cuobjdump -sass): HGMMA is wgmma, UTMALDG a TMA load, HMMA
# is mma.sync; a kernel with none of them is SIMT.
DESIGNS = (("wgmma+tma", {"HGMMA", "UTMALDG"}), ("mma.sync", {"HMMA"}),
           ("simt", set()))
# The kernels whose bf16 instantiations must be wgmma+tma at every head dim.
WGMMA_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# bf16 cases at the edges of the kernels' tiles (128 query rows and 128
# keys in K1, 64 or 128 keys and 64 queries in K3), run by both compare
# phases: S one below and above 128 and 256, causal and not, B*H = 1,
# head_dim 128 non-causal, and more blocks (512) than the card has SMs.
EDGE_CASES = [
    ((1, 1, 127, 64), True), ((1, 1, 127, 64), False),
    ((2, 3, 129, 64), True), ((2, 3, 129, 128), False),
    ((1, 4, 255, 32), True), ((1, 4, 255, 16), False),
    ((2, 2, 257, 128), True), ((2, 2, 257, 64), False),
    ((2, 4, 256, 128), False),
    ((4, 64, 256, 64), True),
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks_for(name: str) -> dict:
    for key, peak in PEAKS:
        if key in name:
            return {"matched": key, **peak}
    return {"matched": "H100 (default)", **PEAKS[-1][1]}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median of per-call CUDA-event times, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(shape, dtype_bytes: int, causal: bool, peak: float,
                    bw: float, matmuls: int = 2, tensors: int = 4,
                    rows: int = 0):
    """(bound_ms, bound_by): ``tensors`` [B, H, S, D] read or written once
    and ``rows`` f32 [B, H, S] read or written once, against the flops of
    ``matmuls`` products over the (causal) pairs this run computes. K1:
    QK^T and PV; q, k, v read, o written. K2 (3, 6, 2): 3 products; q, k,
    v, dO and O read, dq written, lse read and delta written. K3 (4, 6,
    2): 4 products; 4 read, dk and dv written, lse and delta read."""
    b, h, s, d = shape
    nbytes = tensors * b * h * s * d * dtype_bytes + rows * b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * matmuls * b * h * d * pairs
    t_bytes, t_ops = nbytes / bw, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         peaks=peaks_for(name))
    return peaks_for(name)


def phase_build():
    from ray_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    report = _kernels.build()
    seconds = time.perf_counter() - t0
    with open(os.path.join(_kernels.BUILD_DIR, "build_log.txt"), "w") as f:
        for name, rep in report.items():
            f.write(f"== {name} ({rep['seconds']:.1f} s)\n{rep['log']}\n")
    ptxas = ptxas_report(rep["log"] for rep in report.values())
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass = "".join(subprocess.run(
        [cuobjdump, "-sass", rep["path"]], capture_output=True, text=True,
        timeout=300, check=True).stdout for rep in report.values())
    with open(os.path.join(_kernels.BUILD_DIR, "sass.txt"), "w") as f:
        f.write(sass)
    designs = sass_designs(sass)
    emit("build", seconds=seconds,
         sources={n: r["seconds"] for n, r in report.items()}, ptxas=ptxas,
         designs=designs)
    spilled = spilling_kernels(ptxas, "bf16")
    check(not spilled, f"bf16 kernels spill registers: {spilled}")
    for name in WGMMA_KERNELS:
        found = {d: designs.get(f"{name}_bf16_kernel<{d}>")
                 for d in (16, 32, 64, 128)}
        check(set(found.values()) == {"wgmma+tma"},
              f"bf16 {name} is not wgmma+tma at every head dim: {found}")
    return designs


def _kernel_key(mangled: str) -> str:
    k = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_(?:bf16|f32)_kernel)"
                  r"ILi(\d+)E", mangled)
    return f"{k.group(1)}<{k.group(2)}>" if k else mangled


def ptxas_report(logs) -> dict:
    """Registers, spills and shared memory per compiled kernel from
    ``-Xptxas -v``, keyed by the kernel and its head_dim, with ptxas's
    performance notes on it (C75xx: wgmma serialised, setmaxnreg
    ignored) under "notes"."""
    out, name = {}, None
    for log in logs:
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            note = re.search(r"\((C75\d\d)\) (.*?)(?: for the function "
                             r"'(\S+)')?\.?$", line)
            if m:
                name = _kernel_key(m.group(1))
                out.setdefault(name, {})
            elif note:
                # A note names its function or follows its entry; one that
                # does neither is kept under "ptxas".
                key = _kernel_key(note.group(3)) if note.group(3) \
                    else name or "ptxas"
                out.setdefault(key, {}).setdefault("notes", []).append(
                    f"{note.group(1)} {note.group(2)}")
            elif name and "spill" in line:
                out[name]["spill"] = line.strip()
            elif name and "registers" in line:
                out[name]["registers"] = line.split(":", 1)[-1].strip()
    return out


def sass_designs(sass: str) -> dict:
    """The design of each kernel in ``cuobjdump -sass`` output (see
    DESIGNS), keyed like ptxas_report; a mix that DESIGNS does not name is
    reported as its instructions."""
    found, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_key(m.group(1))
            found.setdefault(name, set())
        elif name:
            found[name].update(op for op in ("HGMMA", "UTMALDG", "HMMA")
                               if op in line)
    return {k: next((d for d, want in DESIGNS if ops == want),
                    "+".join(sorted(ops)))
            for k, ops in found.items()}


def kernel_design(designs: dict, name: str) -> str:
    """The design of kernel ``name``'s bf16 instantiations, joined with
    "," where head dims differ."""
    return ",".join(sorted({d for k, d in designs.items()
                            if k.startswith(f"{name}_bf16_kernel<")}))


def spilling_kernels(report: dict, dtype: str) -> list:
    """The kernels of ``dtype`` in a ptxas_report that spill registers."""
    out = []
    for name, props in report.items():
        m = re.search(r"(\d+) bytes spill stores", props.get("spill", ""))
        if f"_{dtype}_" in name and m and int(m.group(1)) > 0:
            out.append(name)
    return sorted(out)


def _plain_lse(q, k, causal: bool, scale: float):
    """logsumexp of the scaled, masked f32 logits (the forward's lse)."""
    import torch

    from ray_tpu_torch.ops.attention import DEFAULT_MASK_VALUE

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    return torch.logsumexp(s, dim=-1)


def phase_compare(peaks):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import mha_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ((1, 2, 256, 64), torch.float32, True),
        ((1, 2, 256, 64), torch.float32, False),
        ((1, 2, 256, 64), torch.bfloat16, True),
        ((1, 2, 256, 64), torch.bfloat16, False),
        ((3, 5, 128, 32), torch.float32, True),
        ((3, 5, 128, 32), torch.bfloat16, True),
        ((2, 3, 200, 64), torch.float32, True),     # ragged S
        ((2, 3, 200, 64), torch.bfloat16, False),   # ragged S
        ((2, 4, 128, 16), torch.bfloat16, True),    # head_dim 16
        ((2, 4, 256, 128), torch.float32, True),
        ((16, 12, 1024, 64), torch.bfloat16, True),   # GPT-2-small slice
        ((8, 8, 2048, 128), torch.bfloat16, True),    # llama bench shape
    ] + [(shape, torch.bfloat16, causal) for shape, causal in EDGE_CASES]
    timed = {GPT2_SHAPE, LLAMA_SHAPE}
    results = {}
    for shape, dtype, causal in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1])
        out, lse = _kernels.flash_fwd(q, k, v, causal, scale, save_lse=True)
        out_nolse, none = _kernels.flash_fwd(q, k, v, causal, scale)
        ref = mha_reference(q, k, v, causal, scale)
        lse_ref = _plain_lse(q, k, causal, scale)
        torch.cuda.synchronize()
        abs_err = float((out.float() - ref.float()).abs().max())
        norm_err = abs_err / float(ref.float().abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        finite = bool(torch.isfinite(out).all())
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "causal": causal, "max_abs_err": abs_err,
               "max_norm_err": norm_err, "lse_max_abs_err": lse_err}
        if dtype == torch.float32:
            ok = abs_err <= TOL_F32_ABS
            row["tol"] = f"abs {TOL_F32_ABS}"
        else:
            ok = norm_err <= TOL_BF16_NORM
            row["tol"] = f"norm {TOL_BF16_NORM}"
        same = bool(torch.equal(out, out_nolse)) and none is None
        if tuple(shape) in timed:
            fl = peaks["bf16"] if dtype == torch.bfloat16 else peaks["f32"]
            bound_ms, bound_by = attention_bound(
                shape, q.element_size(), causal, fl, peaks["bytes"])
            row.update(
                ms=cuda_ms(lambda: _kernels.flash_fwd(q, k, v, causal,
                                                      scale)),
                plain_ms=cuda_ms(lambda: mha_reference(q, k, v, causal,
                                                       scale)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=scale)),
                bound_ms=bound_ms, bound_by=bound_by)
        emit("compare", **row)
        check(finite, f"non-finite kernel output at {shape}")
        check(ok, f"flash_fwd disagrees with mha_reference at {row}")
        check(lse_err <= TOL_LSE_ABS, f"lse disagrees at {row}")
        check(same, f"output with and without lse differ at {shape}")
        results[(tuple(shape), row["dtype"], causal)] = row
        del q, k, v, out, out_nolse, ref, lse, lse_ref
        torch.cuda.empty_cache()
    return results


def _prompts(n: int, lo: int, hi: int):
    words = ("serving", "attention", "kernel", "tile", "warp", "cache",
             "token", "batch", "stream", "softmax", "tensor", "core")
    out = []
    for i in range(n):
        target = lo + (hi - lo) * i // max(1, n - 1)
        text, j = "", i
        while len(text) < target:
            text += words[j % len(words)] + " "
            j += 7
        out.append(text[:target])
    return out


def phase_slice():
    import numpy as np
    import torch

    from ray_tpu_torch.llm import (DetokenizeStage, GPTInferenceStage,
                                   TokenizeStage)
    from ray_tpu_torch.models import GPTConfig, gpt_forward
    from ray_tpu_torch.models.convert import params_to
    from ray_tpu_torch.ops import _kernels

    cfg = GPTConfig.gpt2_small()
    steps = 8
    stage = GPTInferenceStage(config=cfg, max_new_tokens=steps,
                              device="cuda")
    tokenize = TokenizeStage(max_length=cfg.max_seq_len)
    batch = tokenize({"prompt": _prompts(16, 600, 1024)})
    check(all(513 <= len(t) <= 1024 for t in batch["tokens"]),
          "prompts must bucket to T=1024")
    stage(batch)  # warm-up: cuBLAS handles and workspaces
    torch.cuda.synchronize()

    def timed_run():
        t0 = time.perf_counter()
        out = stage(batch)  # ends in a device-to-host copy of the tokens
        return out, time.perf_counter() - t0

    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0
    out, wall = timed_run()
    launches = dict(_kernels.LAUNCHES)
    walls = [wall] + [timed_run()[1] for _ in range(4)]  # not counted

    news = np.stack(out["generated_tokens"])
    text = DetokenizeStage()(out)["generated_text"]
    expected = cfg.n_layers * steps
    wall = statistics.median(walls)
    emit("slice", config="gpt2_small", batch=16, bucket=1024, steps=steps,
         wall_s_runs=walls, wall_s_median=wall,
         tokens_per_s=16 * steps / wall,
         forward_tokens_per_s=16 * 1024 * steps / wall,
         launches=launches, expected_flash_launches=expected,
         generated_shape=list(news.shape), texts=len(text))
    check(launches["flash_fwd"] == expected,
          f"flash_fwd launched {launches['flash_fwd']} times, want {expected}")
    check(news.shape == (16, steps) and news.min() >= 0
          and news.max() < cfg.vocab_size, "generated tokens out of range")

    # First-step logits of 2 prompts at T=128: card (kernel) vs CPU (plain).
    small = tokenize({"prompt": _prompts(2, 100, 128)})["tokens"]
    toks = np.zeros((2, 128), np.int64)
    for i, t in enumerate(small):
        toks[i, 128 - len(t):] = t
    with torch.inference_mode():
        card = gpt_forward(stage._params, torch.from_numpy(toks).cuda(), cfg)
        cpu = gpt_forward(params_to(stage._params, "cpu"),
                          torch.from_numpy(toks), cfg)
    err = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    emit("slice_vs_cpu", shape=[2, 128], max_norm_err=err,
         tol=TOL_MODEL_NORM, finite=bool(torch.isfinite(card).all()))
    check(bool(torch.isfinite(card).all()), "non-finite logits on the card")
    check(err <= TOL_MODEL_NORM, f"card vs CPU logits differ by {err}")
    profile_device(lambda: stage(batch), "profile",
                   "GPTInferenceStage, gpt2_small, 16x1024, 8 steps")
    return launches


def _kernel_group(name: str) -> str:
    low = name.lower()
    for kernel, group in (("flash_fwd", "K1 flash_fwd (this port)"),
                          ("flash_bwd_dq", "K2 flash_bwd_dq (this port)"),
                          ("flash_bwd_dkv", "K3 flash_bwd_dkv (this port)")):
        if kernel in low:
            return group
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "multi_tensor" in low or "foreach" in low or "adam" in low:
        return "optimizer (AdamW)"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reductions"
    if "cat" in low or "copy" in low or "index" in low or "gather" in low \
            or "scatter" in low or "embedding" in low:
        return "copies and indexing"
    return "elementwise"


def profile_device(fn, phase: str, what: str):
    """Device time by kernel and by group over one call of ``fn``, and the
    device's idle share of its wall time, from torch.profiler (reported as
    it comes: an empty trace reads as no kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    kernels, groups = [], {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((us, ev.key[:90], ev.count))
        group = _kernel_group(ev.key)
        groups[group] = groups.get(group, 0.0) + us
    kernels.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in kernels) / 1e3
    emit(phase, what=what,
         wall_ms_profiled=wall * 1e3, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / (wall * 1e3)) if kernels else None,
         groups_ms={g: us / 1e3 for g, us in sorted(
             groups.items(), key=lambda kv: -kv[1])},
         top_kernels=[{"ms": us / 1e3, "calls": n, "name": name}
                      for us, name, n in kernels[:12]])


def phase_online():
    import numpy as np
    import torch

    from ray_tpu_torch.llm import ContinuousBatchingEngine, LLMEngine
    from ray_tpu_torch.models import GPTConfig, gpt_forward
    from ray_tpu_torch.models.generate import (generate, init_cache,
                                               make_generate_fns)

    cfg = GPTConfig.gpt2_small()
    new = 32
    engine = LLMEngine(cfg=cfg, device="cuda", seed=1)
    prompts = _prompts(4, 40, 200)
    texts = [engine.complete(p, max_new_tokens=new) for p in prompts]
    check(all(isinstance(t, str) for t in texts), "complete() must answer")

    # Time to first token and decode rate, on the generator stream() reads.
    ttft, rates = [], []
    for p in prompts:
        ids = np.asarray([engine.tokenizer.encode(p)], np.int64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = generate(engine.params, cfg, ids, max_new_tokens=new)
        first = int(next(gen)[0])
        t1 = time.perf_counter()
        rest = [int(t[0]) for t in gen]
        t2 = time.perf_counter()
        check(len(rest) == new - 1 and 0 <= first < cfg.vocab_size,
              "generate() must yield every token")
        ttft.append(t1 - t0)
        rates.append((new - 1) / (t2 - t1))

    # The KV-cache path against a full forward over the same tokens.
    ids = torch.tensor([engine.tokenizer.encode(prompts[1])],
                       device="cuda")
    lp, steps = ids.shape[1], 8
    prefill, decode_step = make_generate_fns(cfg, 256)
    with torch.inference_mode():
        cache = init_cache(cfg, 1, 256, "cuda")
        logits, cache = prefill(engine.params, ids, cache)
        cached, toks = [logits[0]], []
        for i in range(steps - 1):
            tok = logits.argmax(-1)
            toks.append(tok)
            logits, cache = decode_step(engine.params, tok, lp + i, cache)
            cached.append(logits[0])
        seq = torch.cat([ids, torch.stack(toks, 1)], 1)
        full = gpt_forward(engine.params, seq, cfg)[0, lp - 1:]
    cached = torch.stack(cached)
    kv_err = float((cached - full).abs().max() / full.abs().max())

    # Continuous batching: 8 concurrent requests decode in one batch.
    ceng = ContinuousBatchingEngine(cfg=cfg, params=engine.params,
                                    max_batch=8, device="cuda")
    requests = _prompts(8, 30, 300)
    t0 = time.perf_counter()
    streams = [ceng.submit(p, max_new_tokens=new) for p in requests]
    answers = ["".join(s) for s in streams]
    wall = time.perf_counter() - t0
    ceng.close()
    ceng._thread.join(timeout=60)
    emit("online", config="gpt2_small", new_tokens=new,
         ttft_ms=[t * 1e3 for t in ttft],
         ttft_ms_median=statistics.median(ttft) * 1e3,
         decode_tokens_per_s=rates,
         decode_tokens_per_s_median=statistics.median(rates),
         kv_cache_vs_full_norm_err=kv_err, tol=TOL_MODEL_NORM,
         continuous_requests=len(answers), continuous_steps=ceng.steps,
         continuous_wall_s=wall,
         continuous_tokens_per_s=len(requests) * new / wall)
    check(kv_err <= TOL_MODEL_NORM,
          f"KV-cache logits differ from the full forward by {kv_err}")
    check(len(answers) == 8 and ceng.steps < 2 * new,
          f"continuous batching took {ceng.steps} steps for 8 requests")
    check(not ceng._thread.is_alive(), "decode thread did not stop")


def _norm_err(out, ref, floor: float = 1.0) -> float:
    return float((out.float() - ref.float()).abs().max()) / max(
        floor, float(ref.float().abs().max()))


def delta_err(delta, do, o) -> float:
    """The largest |delta - rowsum(do * o)| over the row's sum of
    |do * o|, the sums in f32 (see TOL_DELTA)."""
    import torch

    prod = do.float() * o.float()
    gap = (delta - prod.sum(-1)).abs()
    mag = prod.abs().sum(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float((gap / mag).max())


def phase_compare_bwd(peaks):
    """K2 and K3 through flash_attention's autograd backward against
    flash_bwd_reference on the card; K2's delta against rowsum(dO * O);
    the reference against autograd through mha_reference in f32; times
    at the two model shapes."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import (flash_attention,
                                             flash_bwd_dkv_reference,
                                             flash_bwd_dq_reference,
                                             flash_bwd_reference,
                                             mha_reference)

    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ((1, 2, 256, 64), f32, True), ((1, 2, 256, 64), f32, False),
        ((1, 2, 256, 64), bf16, True), ((1, 2, 256, 64), bf16, False),
        ((3, 5, 128, 32), f32, True), ((3, 5, 128, 32), bf16, True),
        ((2, 3, 200, 64), f32, True), ((2, 3, 200, 64), bf16, False),
        ((2, 3, 200, 64), bf16, True),                # ragged S
        ((2, 4, 128, 16), f32, True), ((2, 4, 128, 16), bf16, True),
        ((2, 4, 256, 128), f32, True), ((2, 4, 256, 128), bf16, True),
        ((16, 12, 1024, 64), bf16, True),   # GPT-2-small train step
        ((8, 8, 2048, 128), bf16, True),    # llama bench shape
    ] + [(shape, bf16, causal) for shape, causal in EDGE_CASES]
    timed = {GPT2_SHAPE, LLAMA_SHAPE}
    results = {}
    for shape, dtype, causal in cases:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        scale = 1.0 / math.sqrt(shape[-1])
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, causal, scale)
        before = dict(_kernels.LAUNCHES)
        grads = torch.autograd.grad(out, leaves, do)
        ran = {n: _kernels.LAUNCHES[n] - before[n]
               for n in ("flash_bwd_dq", "flash_bwd_dkv")}
        o, lse = _kernels.flash_fwd(q, k, v, causal, scale, save_lse=True)
        ref = flash_bwd_reference(q, k, v, o, lse, do, causal, scale)
        # K2 and K3 twice each on the same inputs, K3 on K2's delta: each
        # block owns its output rows and sums in a fixed order, so the
        # two calls must be bit-identical.
        dq_first, delta = _kernels.flash_bwd_dq(q, k, v, o, do, lse, causal,
                                                scale)
        dq_again = _kernels.flash_bwd_dq(q, k, v, o, do, lse, causal, scale)
        first = _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        again = _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b)) for a, b in zip(first, again))
        same_dq = all(bool(torch.equal(a, b))
                      for a, b in zip((dq_first, delta), dq_again))
        d_err = delta_err(delta, do, o)
        del first, again, dq_first, dq_again
        names = ("dq", "dk", "dv")
        errs = {n: _norm_err(g, r) for n, g, r in zip(names, grads, ref)}
        abs_errs = {n: float((g.float() - r.float()).abs().max())
                    for n, g, r in zip(names, grads, ref)}
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        del out, grads, leaves

        # The reference itself, in f32, against autograd through the
        # plain forward: an independent check of the formulas.
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        auto_leaves = [x.clone().requires_grad_() for x in (q32, k32, v32)]
        auto = torch.autograd.grad(
            mha_reference(*auto_leaves, causal, scale), auto_leaves, do32)
        ref32 = flash_bwd_reference(
            q32, k32, v32, mha_reference(q32, k32, v32, causal, scale),
            _plain_lse(q32, k32, causal, scale), do32, causal, scale)
        ref_errs = {n: _norm_err(r, a, 0.0)
                    for n, r, a in zip(names, ref32, auto)}
        del auto, auto_leaves, ref32

        tol = TOL_BWD_F32_NORM if dtype == f32 else TOL_BWD_BF16_NORM
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "causal": causal, "max_norm_err": errs,
               "max_abs_err": abs_errs, "tol": tol,
               "ref_vs_autograd_norm_err": ref_errs,
               "ref_tol": TOL_BWD_REF_NORM, "launched": ran,
               "delta_err": d_err, "delta_tol": TOL_DELTA,
               "dq_bit_identical": same_dq, "dkv_bit_identical": same}
        if tuple(shape) in timed:
            fl = peaks["bf16"] if dtype == bf16 else peaks["f32"]
            size = q.element_size()
            row["dq"] = dict(zip(("bound_ms", "bound_by"), attention_bound(
                shape, size, causal, fl, peaks["bytes"], 3, 6, 2)))
            row["dkv"] = dict(zip(("bound_ms", "bound_by"), attention_bound(
                shape, size, causal, fl, peaks["bytes"], 4, 6, 2)))
            row["dq"]["ms"] = cuda_ms(lambda: _kernels.flash_bwd_dq(
                q, k, v, o, do, lse, causal, scale))
            row["dkv"]["ms"] = cuda_ms(lambda: _kernels.flash_bwd_dkv(
                q, k, v, do, lse, delta, causal, scale))
            row["dq"]["plain_ms"] = cuda_ms(lambda: flash_bwd_dq_reference(
                q, k, v, o, do, lse, causal, scale), iters=5)
            row["dkv"]["plain_ms"] = cuda_ms(
                lambda: flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                causal, scale), iters=5)
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = flash_attention(*leaves, causal, scale)
            row["autograd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True))
            # SDPA's backward (dq, dk, dv together): timed, never called
            # by the port.
            lib = [x.clone().requires_grad_() for x in (q, k, v)]
            out_lib = F.scaled_dot_product_attention(*lib, is_causal=causal,
                                                     scale=scale)
            row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_lib, lib, do, retain_graph=True))
            del out, leaves, out_lib, lib
        emit("compare_bwd", **row)
        check(finite, f"non-finite backward kernel output at {shape}")
        check(ran == {"flash_bwd_dq": 1, "flash_bwd_dkv": 1},
              f"the backward did not launch K2 and K3 once each: {ran}")
        check(max(errs.values()) <= tol,
              f"K2/K3 disagree with flash_bwd_reference at {row}")
        check(max(ref_errs.values()) <= TOL_BWD_REF_NORM,
              f"flash_bwd_reference disagrees with autograd at {row}")
        check(d_err <= TOL_DELTA,
              f"K2's delta disagrees with rowsum(dO * O) at {row}")
        check(same_dq, f"two K2 calls on the same inputs differ at {shape}")
        check(same, f"two K3 calls on the same inputs differ at {shape}")
        results[(tuple(shape), row["dtype"], causal)] = row
        del q, k, v, do, o, lse, ref, delta
        torch.cuda.empty_cache()
    return results


def phase_train(peaks):
    """make_train_step(GPTConfig.gpt2_small()) at B=16, S=1024 on the
    card: 1 warm-up step, then 5 timed steps, each closed by fetching the
    loss; the kernels' launches counted over exactly the first timed
    step. Remat on (the preset), then off (what bench.py's bench_tpu
    times)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import GPTConfig, make_train_step
    from ray_tpu_torch.models.convert import tree_leaves
    from ray_tpu_torch.ops import _kernels

    results = {}
    b, s = 16, 1024
    for remat in (True, False):
        cfg = dataclasses.replace(GPTConfig.gpt2_small(), remat=remat)
        init_state, train_step = make_train_step(cfg)
        state = init_state(torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, s), dtype=np.int64)
        batch = (torch.from_numpy(tokens).cuda(),
                 torch.from_numpy(np.roll(tokens, -1, 1)).cuda())
        state, m = train_step(state, batch)  # warm-up
        losses = [float(m["loss"])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps_s = []
        for i in range(5):
            if i == 0:
                for name in _kernels.LAUNCHES:
                    _kernels.LAUNCHES[name] = 0
            t0 = time.perf_counter()
            state, m = train_step(state, batch)
            losses.append(float(m["loss"]))  # the fetch ends the step
            steps_s.append(time.perf_counter() - t0)
            if i == 0:
                launches = dict(_kernels.LAUNCHES)
        step = statistics.median(steps_s)
        layers = cfg.n_layers
        # K1 runs in every layer's forward and, under remat, again when
        # the checkpointed block is recomputed in the backward.
        expected = {"flash_fwd": layers * (2 if remat else 1),
                    "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
        row = {"config": "gpt2_small", "remat": remat, "batch": b,
               "seq": s, "dtype": "bfloat16", "params": n_params,
               "step_ms_runs": [t * 1e3 for t in steps_s],
               "step_ms_median": step * 1e3,
               "tokens_per_s": b * s / step,
               "mfu": 6 * n_params * b * s / step / peaks["bf16"],
               "mfu_peak": f"bf16 {peaks['bf16']:.4g} FLOP/s "
                           f"({peaks['matched']})",
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "losses": losses, "launches": launches,
               "expected_launches": expected}
        emit("train", **row)
        check(all(math.isfinite(x) for x in losses), f"loss {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(launches == expected,
              f"launches over one step {launches}, want {expected}")
        results[remat] = row
        del state, batch, m
        torch.cuda.empty_cache()
    return results


def phase_train_vs_cpu():
    """One train step at GPT-2-small width with 2 layers, on the card and
    on the CPU from the same weights and batch: the loss, every gradient
    and every param after the AdamW update."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import GPTConfig, gpt_init, make_train_step
    from ray_tpu_torch.models.convert import params_to, tree_leaves

    # (dtype, T, tolerances), normalized by each leaf's max |cpu|:
    # f32: the same math summed in other orders on two devices. The
    #   gradients agree to rounding; AdamW's first step moves a weight by
    #   about lr * sign(g) = 3e-4 whatever |g| is, so a gradient within
    #   rounding of 0 can move its weight by up to 2 lr: the param band is
    #   lr-scale, not rounding-scale.
    # bf16 at a ragged T: every matmul output and each gradient is
    #   rounded to bf16 at other points; the params are bf16, whose ulp
    #   (2**-8 of the value) exceeds a step of 3e-4 above ~0.08, so
    #   whether a weight moves turns on rounding.
    runs = [("float32", 128, {"loss": 1e-5, "grads": 1e-3,
                              "params": 1e-2}),
            ("bfloat16", 100, {"loss": 1e-2, "grads": 5e-2,
                               "params": 3e-2})]
    for dtype, t, tol in runs:
        cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layers=2,
                                  dtype=getattr(torch, dtype))
        params = gpt_init(cfg, torch.Generator().manual_seed(2), "cpu")
        tokens = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, t + 1), dtype=np.int64)
        batch = (torch.from_numpy(tokens[:, :-1]),
                 torch.from_numpy(tokens[:, 1:]))
        states = {}
        for dev in ("cuda", "cpu"):
            init_state, train_step = make_train_step(cfg, device=dev)
            # params_to copies to the card; the CPU state takes the
            # originals, after the card's copy is made.
            state = init_state(params=params_to(params, dev))
            state, m = train_step(state, batch)
            states[dev] = (state, float(m["loss"]))
        (card, loss_card), (cpu, loss_cpu) = states["cuda"], states["cpu"]
        leaves_card = tree_leaves(card["params"])
        leaves_cpu = tree_leaves(cpu["params"])
        grads = max(_norm_err(a.grad.cpu(), b.grad, 0.0)
                    for a, b in zip(leaves_card, leaves_cpu))
        after = max(_norm_err(a.detach().cpu(), b.detach(), 0.0)
                    for a, b in zip(leaves_card, leaves_cpu))
        loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
        finite = all(bool(torch.isfinite(p).all()) for p in leaves_card)
        emit("train_vs_cpu", config="gpt2_small width, 2 layers",
             dtype=dtype, batch=2, seq=t, loss_card=loss_card,
             loss_cpu=loss_cpu, loss_rel_err=loss_err,
             grads_max_norm_err=grads, params_max_norm_err=after,
             leaves=len(leaves_card), tol=tol, finite=finite)
        check(finite, f"non-finite params on the card ({dtype})")
        check(loss_err <= tol["loss"], f"{dtype} loss differs: {loss_err}")
        check(grads <= tol["grads"], f"{dtype} gradients differ: {grads}")
        check(after <= tol["params"], f"{dtype} params differ: {after}")
        del states, card, cpu, leaves_card, leaves_cpu
        torch.cuda.empty_cache()


def phase_train_profile():
    """Device time by kernel group over one GPT-2-small train step (the
    preset: remat on, B=16, S=1024), and the device's idle share of that
    step's wall time."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import GPTConfig, make_train_step

    cfg = GPTConfig.gpt2_small()
    init_state, train_step = make_train_step(cfg)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (16, 1024), dtype=np.int64)
    batch = (torch.from_numpy(tokens).cuda(),
             torch.from_numpy(np.roll(tokens, -1, 1)).cuda())
    state, m = train_step(state, batch)  # warm-up
    float(m["loss"])

    def one_step():
        _, out = train_step(state, batch)
        float(out["loss"])

    profile_device(one_step, "train_profile",
                   "make_train_step, gpt2_small, remat, 16x1024, 1 step")
    del state
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)

    # No TF32 anywhere: the plain versions are the f32 ground truth.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    peaks = phase_device()
    designs = phase_build()
    compared = phase_compare(peaks)
    compared_bwd = phase_compare_bwd(peaks)
    serving = phase_slice()
    phase_online()
    trained = phase_train(peaks)
    phase_train_vs_cpu()
    phase_train_profile()

    # Launches on each main path, each counted over exactly its run:
    # the batch serving slice, one train step with remat (the preset) and
    # one without.
    by_path = {name: {"serving": serving[name],
                      "train": trained[True]["launches"][name],
                      "train_no_remat": trained[False]["launches"][name]}
               for name in serving}
    slice_row = compared[(GPT2_SHAPE, "bfloat16", True)]
    llama_row = compared[(LLAMA_SHAPE, "bfloat16", True)]
    emit("flash_fwd_llama_shape", **llama_row)
    bwd_row = compared_bwd[(GPT2_SHAPE, "bfloat16", True)]
    bwd_llama = compared_bwd[(LLAMA_SHAPE, "bfloat16", True)]
    emit("flash_bwd_llama_shape", **bwd_llama)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "design": kernel_design(designs, "flash_fwd"),
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:89",
        "launches": sum(by_path["flash_fwd"].values()),
        "launches_by_path": by_path["flash_fwd"],
        "max_abs_err": slice_row["max_abs_err"],
        "max_err": max(r["max_norm_err"] for r in compared.values()),
        "ms": slice_row["ms"], "plain_ms": slice_row["plain_ms"],
        "bound_ms": slice_row["bound_ms"], "bound_by": slice_row["bound_by"],
        "library_ms": slice_row["library_ms"],
        "shape": slice_row["shape"], "dtype": slice_row["dtype"],
        "llama_shape": {
            "shape": llama_row["shape"], "ms": llama_row["ms"],
            "bound_ms": llama_row["bound_ms"],
            "bound_by": llama_row["bound_by"],
            "library_ms": llama_row["library_ms"]},
    }]
    for name, key, grads, line in (("flash_bwd_dq", "dq", ("dq",), 233),
                                   ("flash_bwd_dkv", "dkv", ("dk", "dv"),
                                    280)):
        extra = {"max_delta_err": max(r["delta_err"]
                                      for r in compared_bwd.values())} \
            if name == "flash_bwd_dq" else {}
        kernels.append({
            "name": name, "route": "cuda",
            "design": kernel_design(designs, name),
            "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/attention.py:{line}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": max(bwd_row["max_abs_err"][g] for g in grads),
            "max_err": max(r["max_norm_err"][g] for r in compared_bwd.values()
                           for g in grads),
            "ms": bwd_row[key]["ms"], "plain_ms": bwd_row[key]["plain_ms"],
            "bound_ms": bwd_row[key]["bound_ms"],
            "bound_by": bwd_row[key]["bound_by"],
            # one SDPA backward computes dq, dk and dv together
            "library_ms": bwd_row["library_ms"],
            "shape": bwd_row["shape"], "dtype": bwd_row["dtype"],
            "llama_shape": {
                "shape": bwd_llama["shape"], "ms": bwd_llama[key]["ms"],
                "bound_ms": bwd_llama[key]["bound_ms"],
                "bound_by": bwd_llama[key]["bound_by"],
                "library_ms": bwd_llama["library_ms"]},
            **extra,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
