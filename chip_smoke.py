#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the port's kernels from ``ray_tpu_torch/ops/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
drives the port's serving paths at GPT-2-small width, and prints one JSON
line per phase:

  1. device   the card (nvidia-smi name and power limit), torch and CUDA
  2. build    kernel build seconds and ptxas's register and shared
              memory report; the full compiler output goes to
              ray_tpu_torch/_build/build_log.txt
  3. compare  flash_fwd vs mha_reference at the test and model shapes,
              with its lse; kernel, plain and SDPA times at the two
              model shapes
  4. slice    GPTInferenceStage (the batch serving path that runs the
              kernel): 16 prompts bucketed to T=1024, 8 greedy steps,
              the kernel's launches counted over exactly that run; its
              first-step logits against the port on the CPU
  5. online   LLMEngine and ContinuousBatchingEngine at GPT-2-small
              width: time to first token, decode tokens/s, and the KV-cache
              logits against a full forward
  6. kernels  one entry per kernel: launches, error, times and bound

and, as its last line, {"ok": true, "device": {...}}. Any failed phase or
comparison raises, so the script exits non-zero without the last line.
Without a CUDA card, or without the repository around it, it exits
non-zero at once.

Numbers here are measured on the card of this run; write them down with
the card's name and power limit printed in phase 1.
"""

from __future__ import annotations

import json
import math
import os
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
                    bw: float):
    """(bound_ms, bound_by): q, k, v read once and o written once, against
    the flops of QK^T and PV over the (causal) pairs this run computes."""
    b, h, s, d = shape
    nbytes = 4 * b * h * s * d * dtype_bytes
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
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
    ptxas = [line.strip() for rep in report.values()
             for line in rep["log"].splitlines() if "registers" in line]
    emit("build", seconds=seconds,
         kernels={n: r["seconds"] for n, r in report.items()},
         ptxas=ptxas)


def phase_compare(peaks):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import DEFAULT_MASK_VALUE, mha_reference

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
    ]
    timed = {(16, 12, 1024, 64), (8, 8, 2048, 128)}
    results = {}
    for shape, dtype, causal in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1])
        out, lse = _kernels.flash_fwd(q, k, v, causal, scale, save_lse=True)
        out_nolse, none = _kernels.flash_fwd(q, k, v, causal, scale)
        ref = mha_reference(q, k, v, causal, scale)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if causal:
            mask = torch.ones(shape[2], shape[2], dtype=torch.bool,
                              device="cuda").tril()
            logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
        lse_ref = torch.logsumexp(logits, dim=-1)
        del logits
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
    phase_profile(stage, batch)
    return launches


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd (this port)"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reductions"
    if "cat" in low or "copy" in low or "index" in low or "gather" in low:
        return "copies and indexing"
    return "elementwise"


def phase_profile(stage, batch):
    """Device time by kernel over one slice run (8 greedy steps), and the
    device's idle share of that run's wall time, from torch.profiler
    (reported as it comes: an empty trace reads as no kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stage(batch)
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
    emit("profile", what="GPTInferenceStage, gpt2_small, 16x1024, 8 steps",
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
    phase_build()
    compared = phase_compare(peaks)
    launches = phase_slice()
    phase_online()

    slice_row = compared[((16, 12, 1024, 64), "bfloat16", True)]
    llama_row = compared[((8, 8, 2048, 128), "bfloat16", True)]
    emit("flash_fwd_llama_shape", **llama_row)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:89",
        "launches": launches["flash_fwd"],
        "max_abs_err": slice_row["max_abs_err"],
        "max_err": max(r["max_norm_err"] for r in compared.values()),
        "ms": slice_row["ms"], "plain_ms": slice_row["plain_ms"],
        "bound_ms": slice_row["bound_ms"], "bound_by": slice_row["bound_by"],
        "library_ms": slice_row["library_ms"],
        "shape": slice_row["shape"], "dtype": slice_row["dtype"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
