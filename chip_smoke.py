#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the port's kernels from ``ray_tpu_torch/ops/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
drives the port's serving paths (in process, and hosted by the port's own
control plane: Serve's build_llm_app and Data's Processor) and its train
steps at full width (GPT-2 small, the llama bench shape, ViT-B/16, the MoE
decoder) and the ResNet-50 predictor, and prints one JSON line per
phase:

  1. device         the card (nvidia-smi name and power limit), torch, CUDA
  2. build          kernel build seconds and ptxas's register, spill and
                    shared-memory report per kernel, with its performance
                    notes (wgmma serialised, setmaxnreg ignored), and each
                    kernel's design read from its machine code; fails if
                    a bf16 kernel spills or a bf16 K1, K2 or K3 is not
                    wgmma+tma. The full compiler output and the machine
                    code go to ray_tpu_torch/_build/build_log.txt and
                    sass.txt
  3. compare        flash_fwd (K1) vs mha_reference at the test shapes,
                    at the edges of its 128-row and 128-key tiles (S =
                    127, 129, 255, 257; B*H = 1; more blocks than SMs)
                    and at the attention of each model path (GPT-2
                    small, llama, ViT-B/16's [64,12,197,64] not causal,
                    MoE's [8,8,1024,64]), with its lse; kernel, plain
                    and SDPA times at the model shapes
  4. compare_bwd    flash_bwd_dq (K2) and flash_bwd_dkv (K3), through the
                    autograd backward of flash_attention, vs
                    flash_bwd_reference, and that reference vs autograd
                    through mha_reference, at the same shapes; the delta
                    K2 writes vs rowsum(dO * O); K2 and K3 each called
                    twice on the same inputs (K3 on K2's delta) must give
                    bit-identical outputs; kernel, plain, whole-backward
                    and SDPA-backward times at the model shapes
  5. heads_over_limit  K1, K2 and K3 above gridDim.y's 65,535 batch*heads
                    (causal [4097,16,64,64] forward and backward, ViT's
                    [5462,12,197,64] forward), launched in two chunks:
                    the heads around each chunk boundary and at both
                    ends against the plain versions, the launches, and
                    kernel, plain and SDPA times of K1, and of K2 and K3
                    (against SDPA's backward) at [4097,16,64,64]
  6. slice          GPTInferenceStage (the batch serving path that runs
                    K1): 16 prompts bucketed to T=1024, 8 greedy steps,
                    K1's launches counted over exactly that run; its
                    first-step logits against the port on the CPU
  7. online         LLMEngine and ContinuousBatchingEngine at GPT-2-small
                    width: time to first token, decode tokens/s, and the
                    KV-cache logits against a full forward
  8. runtime        ray_tpu_torch.init(num_cpus=4, num_gpus=1): a task,
                    an actor, put/get of 64 MB; after shutdown the
                    head's own session and store directories
                    ($TMPDIR/rtt_sessions/*, /dev/shm/rtt_<tag>_*) are gone
  9. serve_llm      build_llm_app(GPT-2 small) under the port's Serve,
                    single-stream and continuous batching, the replica
                    reserving the GPU (num_gpus=1: a worker without one
                    sees no card) and drawing the seed-0 weights on it:
                    8 requests through the deployment handle (to the
                    continuous app all at once, so they share its decode
                    batch) and one streamed, each equal to the
                    in-process engine's text (of the same kind, given
                    the requests as the app was); how far each stays
                    from LLMEngine's; median latency and time to first
                    chunk (and the engines' byte-vocab default config
                    when GPT-2's answers are nearly empty)
 10. processor      the build_processor pipeline over a Dataset of the
                    slice's 16 prompts, the GPT stage (GPT-2 small, 8
                    steps) in a Data pool actor that reserves the GPU:
                    tokens equal to the in-process stage's, 96 K1 (and
                    no K2, K3) launches counted in the actor's process;
                    rows/s and tokens/s against the in-process stage;
                    build_processor at its defaults
 11. train          make_train_step(GPTConfig.gpt2_small()) at B=16,
                    S=1024, bf16, remat on (the preset) and off: step ms,
                    tokens/s, MFU, peak memory, the losses, and K1, K2, K3
                    launches counted over exactly one step
 12. train_dp       the same GPT-2-small step (remat on, seed-0 weights
                    and batch) through the port's own Train:
                    ray_tpu_torch.init(num_cpus=4) with the GPU count
                    detected (equal to torch's), a task without a GPU
                    that must see CUDA_VISIBLE_DEVICES="" and no card,
                    then TorchTrainer(ScalingConfig(num_workers=1,
                    use_gpu=True)): in its worker, pinned to GPU 0 on
                    NCCL, one all-reduce of a CUDA tensor through
                    init_collective_group(1, 0, "nccl"), then 5 steps of
                    make_train_step(mesh=make_mesh(MeshConfig(dp=1)),
                    rules=tp_rules()) with K1, K2, K3 launches of 120,
                    60, 60 counted in that process; step ms, tokens/s,
                    MFU, both processes' memory; its 5 losses against
                    phase 11's first 5 steps, and its checkpoint loaded
                    here against the digest of its params
 13. train_vs_cpu   one step at GPT-2-small width and 2 layers, card vs
                    CPU from the same weights: loss, every gradient, every
                    param after AdamW (f32 at T=128, bf16 at ragged T=100)
 14. train_profile  torch.profiler over one train step: device ms by
                    group (K1, K2, K3 each a group) and the idle share
 15. llama_train    make_llama_train_step(LlamaConfig.tpu_bench()) at B=8,
                    S=2048, bf16, remat off (the preset): step ms,
                    tokens/s, MFU, peak memory, the losses, launches
 16. llama_profile  torch.profiler over one llama step, as train_profile
 17. llama_vs_cpu   one llama step at tpu_bench width (GQA 8:2, head_dim
                    128) and 2 layers, card vs CPU, as train_vs_cpu
 18. vit            make_vit_train_step(ViTConfig.vit_b16()) at B=64 on
                    224x224x3 images (non-causal attention at S=197),
                    then make_classifier on 64 images: step ms, images/s,
                    the losses, launches per step and per call
 19. moe_train      make_moe_train_step(MoEConfig()) at B=8, S=1024: step
                    ms, tokens/s, the losses, launches; then one f32 step
                    at 2 layers, card vs CPU, with the share of tokens
                    routed to another pair of experts
 20. resnet         make_predictor(ResNetConfig.resnet50()) on 64 images
                    at 224: images/s; f32 logits of 4 images card vs CPU,
                    and the same with TF32 convolutions, which the band
                    must reject
 21. kernels        one entry per kernel: launches on each main path
                    (the processor's counted in its pool actor, the
                    Train worker's in its process), error,
                    times and bound at the four model shapes and above
                    the head limit, and its design

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


# The timed shapes: the GPT-2-small train and serving shape, the llama
# bench shape (LlamaConfig.tpu_bench() at B=8; causal), ViT-B/16's at
# B=64 (196 patches and the CLS token; not causal) and MoEConfig()'s at
# B=8, S=1024 (causal).
GPT2_SHAPE, LLAMA_SHAPE = (16, 12, 1024, 64), (8, 8, 2048, 128)
VIT_SHAPE, MOE_SHAPE = (64, 12, 197, 64), (8, 8, 1024, 64)
# The attention each model path gives the kernels, (shape, causal), all
# bf16: both compare phases hold K1-K3 there and time them.
MODEL_SHAPES = [(GPT2_SHAPE, True), (LLAMA_SHAPE, True), (VIT_SHAPE, False),
                (MOE_SHAPE, True)]
# Model tolerances of the new families, card vs CPU on the same weights:
# ResNet-50's f32 logits, after dividing by max|ref|: the same products
#   summed in other orders by cuDNN's algorithms (no TF32) and the CPU's,
#   through 53 convolutions. The phase also runs the card with TF32
#   convolutions (inputs rounded to 10 mantissa bits, 2**-11 = 4.9e-4)
#   and fails unless this band rejects that run.
TOL_RESNET_F32_NORM = 1e-4
# MoE: the share of routed tokens whose two experts differ between the
#   card and the CPU in one f32 step (a flip needs a near-tie of the gate
#   logits within the f32 rounding of the router's input).
TOL_MOE_ROUTE_FLIPS = 1e-3

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
    ] + [(shape, torch.bfloat16, causal)
         for shape, causal in MODEL_SHAPES + EDGE_CASES]
    timed = {shape for shape, _ in MODEL_SHAPES}
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

    reset_launches()
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
    at the model shapes."""
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
    ] + [(shape, bf16, causal) for shape, causal in MODEL_SHAPES + EDGE_CASES]
    timed = {shape for shape, _ in MODEL_SHAPES}
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


# Shapes whose batch*heads pass gridDim.y's limit of 65,535, so the
# wrappers launch them in chunks: a causal [4097,16,64,64] forward and
# backward (bh = 65,552) and ViT-B/16's attention on 5,462 images
# (bh = 65,544), forward only, as make_classifier runs it. Each is
# (shape, causal, backward).
OVER_LIMIT_CASES = [((4097, 16, 64, 64), True, True),
                    ((5462, 12, 197, 64), False, False)]


def boundary_heads(bh: int, chunk: int) -> list:
    """The heads a chunked launch over ``bh`` heads could get wrong: both
    ends, and two on each side of every chunk boundary."""
    heads = {0, 1, bh - 2, bh - 1}
    for edge in range(chunk, bh, chunk):
        heads.update(range(edge - 2, edge + 2))
    return sorted(h for h in heads if 0 <= h < bh)


def phase_heads_over_limit(peaks):
    """K1, and K2/K3 where the case has a backward, above 65,535
    batch*heads: the kernels' outputs on the heads around every chunk
    boundary and at both ends against the plain versions on those heads
    (heads are independent, so the subset is an exact comparison), in
    the compare phases' bands; the launches of each call (one per chunk);
    kernel, plain and SDPA times of the forward at the full shape."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import flash_bwd_reference, mha_reference

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for shape, causal, backward in OVER_LIMIT_CASES:
        torch.cuda.empty_cache()
        b, h, s, d = shape
        bh = b * h
        scale = 1.0 / math.sqrt(d)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        heads = boundary_heads(bh, _kernels.HEAD_CHUNK)
        idx = torch.tensor(heads, device="cuda")

        def sub(t):  # the chosen heads, as [n, 1, S, ...]
            return t.reshape(bh, 1, s, *t.shape[3:])[idx]

        reset_launches()
        o, lse = _kernels.flash_fwd(q, k, v, causal, scale, save_lse=True)
        torch.cuda.synchronize()
        launches = {"flash_fwd": _kernels.LAUNCHES["flash_fwd"]}
        ref = mha_reference(sub(q), sub(k), sub(v), causal, scale)
        fwd_err = _norm_err(sub(o), ref, 0.0)
        lse_err = float((sub(lse) - _plain_lse(sub(q), sub(k), causal,
                                               scale)).abs().max())
        finite = bool(torch.isfinite(o).all())
        bound_ms, bound_by = attention_bound(shape, 2, causal, peaks["bf16"],
                                             peaks["bytes"])
        row = {"shape": list(shape), "causal": causal, "bh": bh,
               "chunk": _kernels.HEAD_CHUNK,
               "chunks": len(_kernels.head_chunks(bh)),
               "heads_checked": heads,
               "fwd_max_norm_err": fwd_err, "fwd_tol": TOL_BF16_NORM,
               "fwd_max_abs_err": float((sub(o).float() - ref.float())
                                        .abs().max()),
               "lse_max_abs_err": lse_err, "lse_tol": TOL_LSE_ABS,
               "bound_ms": bound_ms, "bound_by": bound_by}
        del ref
        if backward:
            do = torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            reset_launches()
            dq, delta = _kernels.flash_bwd_dq(q, k, v, o, do, lse, causal,
                                              scale)
            dk, dv = _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                            scale)
            torch.cuda.synchronize()
            launches.update({n: _kernels.LAUNCHES[n]
                             for n in ("flash_bwd_dq", "flash_bwd_dkv")})
            refs = flash_bwd_reference(sub(q), sub(k), sub(v), sub(o),
                                       sub(lse), sub(do), causal, scale)
            row["bwd_max_norm_err"] = {
                n: _norm_err(sub(g), r)
                for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
            row["bwd_tol"] = TOL_BWD_BF16_NORM
            row["delta_err"] = delta_err(sub(delta), sub(do), sub(o))
            finite = finite and all(bool(torch.isfinite(g).all())
                                    for g in (dq, dk, dv))
            del dq, dk, dv, refs
            torch.cuda.empty_cache()
            row.update(time_bwd_over_limit(q, k, v, o, do, lse, delta,
                                           causal, scale, peaks))
            del do, delta
        row["launches"] = launches
        torch.cuda.empty_cache()
        row["ms"] = cuda_ms(lambda: _kernels.flash_fwd(q, k, v, causal,
                                                       scale), 1, 5)
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), 1, 5)
        del o, lse
        torch.cuda.empty_cache()
        row["plain_ms"] = cuda_ms(lambda: mha_reference(q, k, v, causal,
                                                        scale), 1, 3)
        emit("heads_over_limit", **row)
        chunks = row["chunks"]
        check(chunks == 2, f"bh={bh} should run as 2 chunks, got {chunks}")
        check(finite, f"non-finite output above the head limit at {shape}")
        check(fwd_err <= TOL_BF16_NORM and lse_err <= TOL_LSE_ABS,
              f"K1 above the head limit disagrees with the plain version: "
              f"{row}")
        if backward:
            check(max(row["bwd_max_norm_err"].values()) <= TOL_BWD_BF16_NORM
                  and row["delta_err"] <= TOL_DELTA,
                  f"K2/K3 above the head limit disagree: {row}")
        want = {n: chunks for n in launches}
        check(launches == want, f"launches {launches}, want {want}")
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def time_bwd_over_limit(q, k, v, o, do, lse, delta, causal: bool,
                        scale: float, peaks) -> dict:
    """K2 and K3 at a shape above the head limit, two chunked launches a
    call: kernel ms (median of 5 after 1 warm-up), bound, the plain
    versions' ms at the full shape (median of 3), and SDPA's backward (one
    torch.autograd.grad for dq, dk and dv, never called by the port)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv_reference,
                                             flash_bwd_dq_reference)

    shape = tuple(q.shape)
    out = {}
    for key, products, kernel, plain in (
            ("dq", 3, lambda: _kernels.flash_bwd_dq(q, k, v, o, do, lse,
                                                    causal, scale),
             lambda: flash_bwd_dq_reference(q, k, v, o, do, lse, causal,
                                            scale)),
            ("dkv", 4, lambda: _kernels.flash_bwd_dkv(q, k, v, do, lse,
                                                      delta, causal, scale),
             lambda: flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                             causal, scale))):
        bound_ms, bound_by = attention_bound(shape, 2, causal, peaks["bf16"],
                                             peaks["bytes"], products, 6, 2)
        out[key] = {"bound_ms": bound_ms, "bound_by": bound_by,
                    "ms": cuda_ms(kernel, 1, 5)}
        torch.cuda.empty_cache()
        out[key]["plain_ms"] = cuda_ms(plain, 1, 3)
        torch.cuda.empty_cache()
    lib = [x.clone().requires_grad_() for x in (q, k, v)]
    out_lib = F.scaled_dot_product_attention(*lib, is_causal=causal,
                                             scale=scale)
    out["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out_lib, lib, do, retain_graph=True), 1, 5)
    del lib, out_lib
    torch.cuda.empty_cache()
    return out


def copy_dirs(node) -> list:
    """Those of a ray_tpu_torch head's own session and store directories
    that exist (not every rtt_ directory of the machine: another checkout
    may be running beside this one)."""
    return [d for d in (node.session_dir, node.store_dir)
            if os.path.exists(d)]


def current_node():
    from ray_tpu_torch._private import state

    return state.current()


def phase_runtime():
    """The port's control plane on the card's machine: init with the GPU
    declared, a task, an actor, put/get of 64 MB; after shutdown no
    session or store directory of the copy is left."""
    import numpy as np

    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    init_s = time.perf_counter() - t0
    node = current_node()
    try:
        resources = rt.cluster_resources()

        @rt.remote
        def add(x):
            return x + 1

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n, os.getpid()

        t0 = time.perf_counter()
        task = rt.get(add.remote(41), timeout=120)
        task_s = time.perf_counter() - t0
        actor = Counter.remote()
        t0 = time.perf_counter()
        bumps = [rt.get(actor.bump.remote(), timeout=120) for _ in range(3)]
        actor_s = time.perf_counter() - t0
        arr = np.random.default_rng(0).integers(0, 255, 64 << 20,
                                                dtype=np.uint8)
        t0 = time.perf_counter()
        back = rt.get(rt.put(arr), timeout=120)
        put_get_s = time.perf_counter() - t0
        same = bool(np.array_equal(back, arr))
        during = copy_dirs(node)
        del back
    finally:
        rt.shutdown()
    after = copy_dirs(node)
    emit("runtime", init_s=init_s, resources=resources, task=task,
         task_s=task_s, actor_calls_s=actor_s, put_get_64mb_s=put_get_s,
         put_get_equal=same, dirs_during=during, dirs_after=after)
    check(resources.get("GPU") == 1.0, f"GPU not declared: {resources}")
    check(task == 42, f"task returned {task}")
    check([n for n, _ in bumps] == [1, 2, 3]
          and {p for _, p in bumps} != {os.getpid()},
          f"actor calls {bumps} must count in another process")
    check(same, "put/get changed the 64 MB array")
    check(len(during) == 2
          and os.path.basename(node.store_dir).startswith("rtt_"),
          f"session and store directories while running: {during}")
    check(after == [], f"directories left after shutdown: {after}")


SERVE_REQUESTS = 8
SERVE_NEW_TOKENS = 32


def serve_app(cfg, continuous: bool, prompts, new_tokens: int):
    """Deploy build_llm_app(cfg, params=None) (the replica draws the
    engine's seed-0 weights on the card) and send the prompts through the
    deployment handle: to the continuous-batching app all at once, every
    request sent before any answer is awaited, so they decode together in
    its shared batch; to the single-stream app one at a time. Then one
    streaming request. Returns the texts, the seconds from each request's
    send to its answer (for the concurrent ones, to when it was collected,
    in order), the stream's text and its time to first chunk."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_app

    name = f"llm_{'cb' if continuous else 'single'}"
    t0 = time.perf_counter()
    # The replica reserves the card: a worker without a GPU sees none.
    serve.run(build_llm_app(cfg=cfg, continuous_batching=continuous,
                            num_gpus=1),
              name=name, route_prefix=f"/{name}")
    handle = serve.get_deployment_handle("LLMServer", name)
    texts, walls = [], []
    if continuous:
        t1 = time.perf_counter()
        sent = [handle.remote({"body": {"prompt": p,
                                        "max_tokens": new_tokens}})
                for p in prompts]
        for response in sent:
            texts.append(response.result(timeout_s=300)["text"])
            walls.append(time.perf_counter() - t1)
    else:
        for p in prompts:
            t1 = time.perf_counter()
            out = handle.remote({"body": {"prompt": p,
                                          "max_tokens": new_tokens}}
                                ).result(timeout_s=300)
            walls.append(time.perf_counter() - t1)
            texts.append(out["text"])
    deploy_and_answer_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    chunks, first = [], None
    for piece in handle.options(stream=True).remote(
            {"body": {"prompt": prompts[0], "max_tokens": new_tokens,
                      "stream": True}}):
        if first is None:
            first = time.perf_counter() - t1
        chunks.append(piece)
    serve.delete(name)
    return {"texts": texts, "walls": walls, "stream": "".join(chunks),
            "stream_first_s": first, "total_s": deploy_and_answer_s}


def first_difference(a: str, b: str):
    """Index of the first character where two texts differ (the shorter
    one's length when one is a prefix of the other), None when equal."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def serve_config(cname: str, cfg) -> list:
    """Both apps of one config against the in-process engines drawn from
    the same seed-0 weights on this card; one row per app."""
    from ray_tpu_torch.llm import ContinuousBatchingEngine, LLMEngine

    prompts = _prompts(SERVE_REQUESTS, 20, 200)
    single = LLMEngine(cfg, seed=0, device="cuda")
    ref = [single.complete(p, SERVE_NEW_TOKENS) for p in prompts]
    del single
    # The continuous engine decodes its 8 slots as one [8, d] batch, whose
    # bf16 products round apart from the single stream's [1, d]: its app
    # is held to the in-process continuous engine, given the same requests
    # all at once, as the app is. Its decode steps show that they shared
    # the batch (one at a time they would take 8 * (tokens - 1)).
    cb = ContinuousBatchingEngine(cfg, seed=0, device="cuda", max_batch=8)
    streams = [cb.submit(p, SERVE_NEW_TOKENS) for p in prompts]
    ref_cb = ["".join(stream) for stream in streams]
    cb_steps = cb.steps
    cb.close()
    check(cb_steps < 2 * SERVE_NEW_TOKENS,
          f"the continuous engine took {cb_steps} decode steps for "
          f"{len(prompts)} concurrent requests of {SERVE_NEW_TOKENS} tokens")
    rows = []
    for continuous, want in ((False, ref), (True, ref_cb)):
        got = serve_app(cfg, continuous, prompts, SERVE_NEW_TOKENS)
        row = {"config": cname, "continuous_batching": continuous,
               "requests": len(prompts), "max_tokens": SERVE_NEW_TOKENS,
               "latency_s": got["walls"],
               "latency_s_median": statistics.median(got["walls"]),
               "stream_first_chunk_s": got["stream_first_s"],
               "deploy_and_answer_s": got["total_s"],
               "chars": sum(map(len, got["texts"])),
               "equal": sum(a == b for a, b in zip(got["texts"], want)),
               "equal_single_engine": sum(
                   a == b for a, b in zip(got["texts"], ref)),
               "first_diff_single_engine": [
                   first_difference(a, b)
                   for a, b in zip(got["texts"], ref)]}
        if continuous:
            row["in_process_decode_steps"] = cb_steps
        emit("serve_llm", **row)
        check(got["texts"] == want,
              f"{cname} app (continuous={continuous}) answered "
              f"{got['texts']!r}, the in-process engine {want!r}")
        check(got["stream"] == want[0],
              f"stream {got['stream']!r} != {want[0]!r}")
        rows.append(row)
    return rows


def phase_serve_llm():
    """build_llm_app under the port's Serve, both engines, at GPT-2-small
    width: each answer equals the in-process engine's on the same card
    (the replica draws the same seed-0 weights). GPT-2's random weights
    mostly pick ids >= 256, which decode to nothing; when its answers
    hold fewer than 16 characters in all, the engines' default byte-vocab
    config is served and compared too, so the comparison can fail."""
    from ray_tpu_torch.llm.serving import default_engine_config
    from ray_tpu_torch.models import GPTConfig

    rows = serve_config("gpt2_small", GPTConfig.gpt2_small())
    if rows[0]["chars"] < 16:
        rows += serve_config("default_engine_config",
                             default_engine_config())
    return rows


# The processor phase's GPT stage: GPT-2 small, 8 greedy steps over 16
# prompts bucketed to T=1024, K1 once per layer per step.
PROCESSOR_STEPS = 8


def check_worker_launches(rows, driver_pid: int, expected: dict) -> dict:
    """The pool actor's report (the columns CountingStage adds): one call
    in one process that is not the driver's, whose launches of each kernel
    were ``expected``. Returns the pid and the launches it reported."""
    pids = {int(r["stage_pid"]) for r in rows}
    calls = {int(r["stage_call"]) for r in rows}
    names = sorted({k[len("launches_"):] for r in rows for k in r
                    if k.startswith("launches_")})
    reported = {name: {int(r.get("launches_" + name, -1)) for r in rows}
                for name in names}
    check(len(pids) == 1 and driver_pid not in pids,
          f"the stage ran in {pids}, want one process other than "
          f"{driver_pid}")
    check(calls == {1}, f"the stage was called {sorted(calls)} times")
    check(reported == {name: {n} for name, n in expected.items()},
          f"launches in the pool actor {reported}, want {expected}")
    return {"pid": pids.pop(), "calls": 1,
            **{name: counts.pop() for name, counts in reported.items()}}


def counting_stage():
    """A GPTInferenceStage that reports, as columns, the launches of each
    kernel in its own process during the call (``launches_<name>``), its
    pid, its call number and the seconds the call took (defined here, not in the package, so the
    package carries no test hook; cloudpickle ships it by value)."""
    from ray_tpu_torch.llm import GPTInferenceStage

    class CountingStage(GPTInferenceStage):
        calls = 0

        def __call__(self, batch):
            from ray_tpu_torch.ops import _kernels

            CountingStage.calls += 1
            before = dict(_kernels.LAUNCHES)
            t0 = time.perf_counter()
            out = super().__call__(batch)
            seconds = time.perf_counter() - t0
            n = len(out[self._out])
            for name, count in _kernels.LAUNCHES.items():
                out["launches_" + name] = [count - before.get(name, 0)] * n
            out["stage_pid"] = [os.getpid()] * n
            out["stage_call"] = [CountingStage.calls] * n
            out["stage_s"] = [seconds] * n
            return out

    return CountingStage


def phase_processor():
    """The pipeline build_processor builds, over a Dataset of phase_slice's
    16 prompts, with the GPT stage at GPT-2-small width in a pool actor
    on the card: its tokens equal the in-process stage's, and K1 ran 96
    times in the actor's process; then build_processor at its defaults."""
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.llm import (DetokenizeStage, GPTInferenceStage,
                                   Processor, ProcessorConfig, StageSpec,
                                   TokenizeStage, build_processor)
    from ray_tpu_torch.models import GPTConfig

    cfg = GPTConfig.gpt2_small()
    prompts = _prompts(16, 600, 1024)
    stage_kwargs = {"config": cfg, "max_new_tokens": PROCESSOR_STEPS}
    processor = Processor([
        StageSpec(TokenizeStage, {"max_length": cfg.max_seq_len}),
        StageSpec(counting_stage(), stage_kwargs, num_gpus=1),
        StageSpec(DetokenizeStage)], batch_size=16)
    ds = data.from_items([{"prompt": p} for p in prompts])
    t0 = time.perf_counter()
    rows = processor(ds).take_all()
    wall = time.perf_counter() - t0
    expected = {name: n * PROCESSOR_STEPS for name, n in expected_launches(
        cfg.n_layers, remat=False, train=False).items()}
    worker = check_worker_launches(rows, os.getpid(), expected)

    local = GPTInferenceStage(device="cuda", **stage_kwargs)
    batch = TokenizeStage(max_length=cfg.max_seq_len)({"prompt": prompts})
    local(batch)  # warm-up
    t0 = time.perf_counter()
    want = local(batch)["generated_tokens"]
    local_s = time.perf_counter() - t0
    by_prompt = {r["prompt"]: np.asarray(r["generated_tokens"]) for r in rows}
    got = [by_prompt[p] for p in prompts]
    equal = sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))
    stage_s = float(rows[0]["stage_s"])
    new_tokens = 16 * PROCESSOR_STEPS
    emit("processor", config="gpt2_small", rows=len(rows), batch_size=16,
         steps=PROCESSOR_STEPS, pool_actor=worker, driver_pid=os.getpid(),
         equal_rows=equal, pipeline_s=wall, stage_in_actor_s=stage_s,
         in_process_stage_s=local_s, rows_per_s=len(rows) / wall,
         tokens_per_s=new_tokens / wall,
         in_process_rows_per_s=16 / local_s,
         in_process_tokens_per_s=new_tokens / local_s,
         texts=sum(isinstance(r["generated_text"], str) for r in rows))
    check(len(rows) == 16 and equal == 16,
          f"{equal} of {len(rows)} rows equal the in-process stage's tokens")

    t0 = time.perf_counter()
    out = build_processor(ProcessorConfig(batch_size=4, max_new_tokens=2))(
        data.from_items([{"prompt": f"hello world {i}"} for i in range(8)])
    ).take_all()
    emit("build_processor", rows=len(out), seconds=time.perf_counter() - t0,
         generated=[len(r["generated_tokens"]) for r in out])
    check(len(out) == 8 and all(len(r["generated_tokens"]) == 2
                                and isinstance(r["generated_text"], str)
                                for r in out),
          "build_processor at its defaults did not answer every row")
    return worker


def phase_control_plane():
    """serve_llm and processor on one cluster (num_gpus declared), shut
    down at the end, leaving no directory of the copy; returns the pool
    actor's K1 launches."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    torch.cuda.empty_cache()
    rt.init(num_cpus=4, num_gpus=1)
    node = current_node()
    try:
        phase_serve_llm()
        serve.shutdown()
        worker = phase_processor()
    finally:
        rt.shutdown()
    check(copy_dirs(node) == [], f"directories left: {copy_dirs(node)}")
    return worker


def reset_launches() -> None:
    from ray_tpu_torch.ops import _kernels

    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0


def expected_launches(n_layers: int, remat: bool, train: bool = True
                      ) -> dict:
    """K1, K2 and K3 launches over one train step (or, ``train=False``,
    one forward) of a model whose ``n_layers`` blocks each run one
    flash_attention: K1 in every layer's forward and, under remat, again
    when the checkpointed block is recomputed in the backward; K2 and K3
    once a layer in the backward."""
    if not train:
        return {"flash_fwd": n_layers, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
    return {"flash_fwd": n_layers * (2 if remat else 1),
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}


def llama_param_count(cfg) -> int:
    """Every param of a LlamaConfig's model, the embedding and the untied
    head included, from its shapes (what bench.py counts for its MFU)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    layer = 2 * d + d * d + d * kv + d * d + 3 * d * f
    return 2 * v * d + d + cfg.n_layers * layer


def timed_steps(train_step, state, batch, steps: int = 5):
    """1 warm-up step, then ``steps`` timed steps, each closed by
    fetching the loss; the kernels' launches counted over exactly the
    first timed step, the peak memory over the timed ones. Returns
    (losses with the warm-up's first, step seconds, launches)."""
    import torch

    from ray_tpu_torch.ops import _kernels

    state, m = train_step(state, batch)  # warm-up
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_s = []
    for i in range(steps):
        if i == 0:
            reset_launches()
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))  # the fetch ends the step
        steps_s.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(_kernels.LAUNCHES)
    return losses, steps_s, launches


def check_training(phase: str, losses, launches, expected) -> None:
    check(all(math.isfinite(x) for x in losses), f"{phase} loss {losses}")
    check(losses[-1] < losses[0], f"{phase} loss did not fall: {losses}")
    check(launches == expected,
          f"{phase} launches over one step {launches}, want {expected}")


def token_batch(vocab: int, b: int, s: int, seed: int = 0):
    """Random tokens on the card and their next tokens (np.roll)."""
    import numpy as np
    import torch

    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                  dtype=np.int64)
    return (torch.from_numpy(tokens).cuda(),
            torch.from_numpy(np.roll(tokens, -1, 1)).cuda())


def phase_train(peaks):
    """make_train_step(GPTConfig.gpt2_small()) at B=16, S=1024 on the
    card: 1 warm-up step, then 5 timed steps, each closed by fetching the
    loss; the kernels' launches counted over exactly the first timed
    step. Remat on (the preset), then off (what bench.py's bench_tpu
    times)."""
    import torch

    from ray_tpu_torch.models import GPTConfig, make_train_step
    from ray_tpu_torch.models.convert import tree_leaves

    results = {}
    b, s = 16, 1024
    for remat in (True, False):
        cfg = dataclasses.replace(GPTConfig.gpt2_small(), remat=remat)
        init_state, train_step = make_train_step(cfg)
        state = init_state(torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        batch = token_batch(cfg.vocab_size, b, s)
        losses, steps_s, launches = timed_steps(train_step, state, batch)
        step = statistics.median(steps_s)
        expected = expected_launches(cfg.n_layers, remat)
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
        check_training("train", losses, launches, expected)
        results[remat] = row
        del state, batch
        torch.cuda.empty_cache()
    return results


# The train_dp phase: phase_train's GPT-2-small step (remat on, B=16,
# S=1024, seed-0 weights and batch) through the port's TorchTrainer, in a
# worker pinned to the card, on a dp=1 mesh (NCCL at world size 1).
TRAIN_DP_STEPS = 5
# Its losses against the in-process make_train_step's first steps on the
# same weights and batch, relative: the bf16 loss band of train_vs_cpu.
# The worker's step adds the dp all-reduce (at world size 1 a copy
# through f32, exact for bf16), and the embedding's backward sums its
# rows with atomics, in another order in each run.
TOL_TRAIN_DP_LOSS = 1e-2


def state_digest(params) -> str:
    """sha256 over every param's dtype, shape and bytes, in tree_leaves
    order, from CPU copies: the same for a state on the card and for its
    checkpoint loaded on the CPU."""
    import hashlib

    import torch

    from ray_tpu_torch.models.convert import tree_leaves

    digest = hashlib.sha256()
    for p in tree_leaves(params):
        t = p.detach().cpu().contiguous().reshape(-1)
        digest.update(f"{t.dtype}{tuple(p.shape)}".encode())
        digest.update(t.view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def train_dp_loop(config):
    """train_loop_per_worker of the train_dp phase, in each pinned worker:
    one all-reduce of a CUDA tensor through the collective API on nccl
    (rank r gives r + 1), then ``config["steps"]`` steps of
    make_train_step(gpt2_small) on a dp mesh over the workers with
    tp_rules, each on this rank's shard_batch of the global batch and
    closed by fetching the loss, the kernels' launches counted in this
    process over exactly those steps; rank 0 saves the state as a
    checkpoint. Reports what the driver checks, each rank's own values
    gathered in rank order."""
    import tempfile

    import torch
    import torch.distributed as dist

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models import GPTConfig, make_train_step, shard_batch
    from ray_tpu_torch.models.convert import tree_leaves
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, tp_rules
    from ray_tpu_torch.util import collective as col

    torch.backends.cuda.matmul.allow_tf32 = False  # as in the driver
    ctx = train.get_context()
    rank, world = ctx.world_rank, ctx.world_size
    group = f"train_dp/{ctx.experiment_name}"
    col.init_collective_group(world, rank, "nccl", group)
    given = torch.full((4,), float(rank + 1), device="cuda")
    reduced = col.allreduce(given, group)
    collective = {"type": type(reduced).__name__,
                  "device": str(reduced.device),
                  "sum": float(reduced[0])}
    col.destroy_collective_group(group)

    cfg = GPTConfig.gpt2_small()
    b, s = config["batch"], config["seq"]
    mesh = make_mesh(MeshConfig(dp=world))
    init_state, train_step = make_train_step(cfg, mesh=mesh,
                                             rules=tp_rules())
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    batch = shard_batch(token_batch(cfg.vocab_size, b, s), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(_kernels.LAUNCHES)
    losses, steps_s = [], []
    for _ in range(config["steps"]):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))  # the fetch ends the step
        steps_s.append(time.perf_counter() - t0)
    launches = {n: _kernels.LAUNCHES[n] - before.get(n, 0)
                for n in _kernels.LAUNCHES}
    step = statistics.median(steps_s)
    mine = {"pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "gpu_ids": rt.get_gpu_ids(),
            "device_count": torch.cuda.device_count(),
            "launches": launches, "collective_allreduce": collective,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "digest": state_digest(state["params"])}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    metrics = {
        "backend": dist.get_backend(), "world": dist.get_world_size(),
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "ranks": ranks, "params": n_params, "losses": losses,
        "step_ms_runs": [t * 1e3 for t in steps_s],
        "step_ms_median": step * 1e3, "tokens_per_s": b * s / step,
        "mfu": 6 * n_params * b * s / step / (config["peak_bf16"] * world)}
    checkpoint = None
    if rank == 0:
        path = tempfile.mkdtemp(prefix="final_", dir=os.path.join(
            ctx.storage_path, "checkpoints"))
        t0 = time.perf_counter()
        checkpoint = train.Checkpoint.from_state(state, path)
        metrics["checkpoint_save_s"] = time.perf_counter() - t0
    train.report(metrics, checkpoint=checkpoint)


def train_dp_checks(m: dict, reference, driver_pid: int, steps: int
                    ) -> dict:
    """A train_dp report (one entry a rank in ``m["ranks"]``) against what
    the phase requires: each rank pinned to a GPU of its own, which it
    sees as its only card; NCCL over all ranks; the collective's CUDA
    all-reduce of r + 1 summed over the ranks; in every rank, the
    launches of ``steps`` steps with remat, in processes other than the
    driver's; equal params on every rank after the steps; losses within
    the band of ``reference`` (the in-process steps). Returns each check
    by name, and the loss errors."""
    expected = {n: k * steps for n, k in expected_launches(12, True).items()}
    ranks, world = m["ranks"], m["world"]
    ours, theirs = m["losses"], list(reference)[:steps]
    errs = [abs(a - b) / abs(b) for a, b in zip(ours, theirs)]
    ids = [r["gpu_ids"] for r in ranks]
    return {
        "expected_launches": expected,
        "loss_rel_errs": errs,
        "bit_identical": ours == theirs,
        "checks": {
            "pinned": len(ranks) == world
            and sorted(ids) == [[i] for i in range(world)]
            and all(r["cuda_visible_devices"] == str(r["gpu_ids"][0])
                    and r["device_count"] == 1 for r in ranks),
            "nccl": m["backend"] == "nccl",
            "collective": all(r["collective_allreduce"] == {
                "type": "Tensor", "device": "cuda:0",
                "sum": world * (world + 1) / 2} for r in ranks),
            "launches": all(r["launches"] == expected for r in ranks),
            "other_process": len({r["pid"] for r in ranks}) == world
            and driver_pid not in {r["pid"] for r in ranks},
            "ranks_agree": len({r["digest"] for r in ranks}) == 1,
            "losses_finite": len(ours) == steps
            and all(math.isfinite(x) for x in ours),
            "losses_in_band": len(errs) == steps
            and max(errs) <= TOL_TRAIN_DP_LOSS}}


def phase_train_dp(peaks, reference_losses):
    """The GPT-2-small step through the port's own Train: a cluster with
    its GPU count detected (it must equal torch's), a task without a GPU
    that must see no card, then TorchTrainer with one worker that
    reserves the GPU (use_gpu=True) and runs train_dp_loop. Its losses
    are held against phase_train's in-process steps, and its checkpoint,
    loaded here with Checkpoint.to_state, against the digest of its
    params. The driver's and the worker's memory are reported."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    torch.cuda.empty_cache()
    driver_memory = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
                     "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    storage = tempfile.mkdtemp(prefix="rtt_train_dp_")
    rt.init(num_cpus=4)
    node = current_node()
    try:
        resources = rt.cluster_resources()

        @rt.remote
        def without_gpu():
            import torch
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    torch.cuda.is_available(), rt.get_gpu_ids())

        zero_gpu = rt.get(without_gpu.remote(), timeout=120)
        t0 = time.perf_counter()
        result = TorchTrainer(
            train_dp_loop,
            train_loop_config={"steps": TRAIN_DP_STEPS, "batch": 16,
                               "seq": 1024, "peak_bf16": peaks["bf16"]},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="train_dp", storage_path=storage),
        ).fit()
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"train_dp failed: {result.error!r}")
        m = result.metrics
        t0 = time.perf_counter()
        state = result.checkpoint.to_state()
        load_s = time.perf_counter() - t0
        loaded_digest = state_digest(state["params"])
        loaded = {"keys": sorted(state), "step": state["step"]}
        del state
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    got = train_dp_checks(m, reference_losses, os.getpid(), TRAIN_DP_STEPS)
    got["checks"]["detected_gpus"] = \
        resources.get("GPU") == float(torch.cuda.device_count())
    got["checks"]["zero_gpu_task"] = zero_gpu == ("", False, [])
    got["checks"]["checkpoint"] = (
        loaded_digest == m["ranks"][0]["digest"]
        and loaded["step"] == TRAIN_DP_STEPS)
    got["checks"]["no_dirs_left"] = copy_dirs(node) == []
    ranks = [{k: v for k, v in r.items() if k != "digest"}
             for r in m["ranks"]]
    emit("train_dp", config="gpt2_small", remat=True, batch=16, seq=1024,
         dtype="bfloat16", steps=TRAIN_DP_STEPS, workers=1,
         driver_pid=os.getpid(), detected_gpus=resources.get("GPU"),
         zero_gpu_task=list(zero_gpu), fit_s=fit_s,
         checkpoint=dict(loaded, load_s=load_s, digest_equal=loaded_digest
                         == m["ranks"][0]["digest"]),
         reference_losses=list(reference_losses)[:TRAIN_DP_STEPS],
         loss_tol=TOL_TRAIN_DP_LOSS, driver_memory=driver_memory,
         mfu_peak=f"bf16 {peaks['bf16']:.4g} FLOP/s ({peaks['matched']})",
         **got, **dict(m, ranks=ranks))
    failed = [name for name, ok in got["checks"].items() if not ok]
    check(not failed, f"train_dp checks failed: {failed}")
    return ranks[0]


# (dtype, T, tolerances) of one train step card vs CPU, normalized by each
# leaf's max |cpu|:
# f32: the same math summed in other orders on two devices. The gradients
#   agree to rounding; AdamW's first step moves a weight by about
#   lr * sign(g) = 3e-4 whatever |g| is, so a gradient within rounding of 0
#   can move its weight by up to 2 lr: the param band is lr-scale, not
#   rounding-scale.
# bf16 at a ragged T: every matmul output and each gradient is rounded to
#   bf16 at other points; the params are bf16, whose ulp (2**-8 of the
#   value) exceeds a step of 3e-4 above ~0.08, so whether a weight moves
#   turns on rounding.
VS_CPU_RUNS = [("float32", 128, {"loss": 1e-5, "grads": 1e-3,
                                 "params": 1e-2}),
               ("bfloat16", 100, {"loss": 1e-2, "grads": 5e-2,
                                  "params": 3e-2})]


def step_card_vs_cpu(make_step, params, batch):
    """One train step of ``make_step(device)`` on the card and on the CPU
    from the same CPU ``params`` and batch. Returns the two states and
    losses as {"cuda": (state, loss), "cpu": (state, loss)}."""
    from ray_tpu_torch.models.convert import params_to

    states = {}
    for dev in ("cuda", "cpu"):
        init_state, train_step = make_step(dev)
        # params_to copies to the card; the CPU state takes the
        # originals, after the card's copy is made.
        state = init_state(params=params_to(params, dev))
        state, m = train_step(state, batch)
        states[dev] = (state, float(m["loss"]))
    return states


def compare_states(states) -> dict:
    """Loss, every gradient and every param after the step, card against
    CPU, each normalized by the CPU leaf's max."""
    import torch

    from ray_tpu_torch.models.convert import tree_leaves

    (card, loss_card), (cpu, loss_cpu) = states["cuda"], states["cpu"]
    leaves_card = tree_leaves(card["params"])
    leaves_cpu = tree_leaves(cpu["params"])
    return {
        "loss_card": loss_card, "loss_cpu": loss_cpu,
        "loss_rel_err": abs(loss_card - loss_cpu) / abs(loss_cpu),
        "grads_max_norm_err": max(_norm_err(a.grad.cpu(), b.grad, 0.0)
                                  for a, b in zip(leaves_card, leaves_cpu)),
        "params_max_norm_err": max(
            _norm_err(a.detach().cpu(), b.detach(), 0.0)
            for a, b in zip(leaves_card, leaves_cpu)),
        "leaves": len(leaves_card),
        "finite": all(bool(torch.isfinite(p).all()) for p in leaves_card)}


def check_vs_cpu(phase: str, dtype: str, row: dict, tol: dict) -> None:
    check(row["finite"], f"{phase}: non-finite params on the card ({dtype})")
    check(row["loss_rel_err"] <= tol["loss"],
          f"{phase}: {dtype} loss differs: {row['loss_rel_err']}")
    check(row["grads_max_norm_err"] <= tol["grads"],
          f"{phase}: {dtype} gradients differ: {row['grads_max_norm_err']}")
    check(row["params_max_norm_err"] <= tol["params"],
          f"{phase}: {dtype} params differ: {row['params_max_norm_err']}")


def phase_train_vs_cpu():
    """One train step at GPT-2-small width with 2 layers, on the card and
    on the CPU from the same weights and batch: the loss, every gradient
    and every param after the AdamW update."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import GPTConfig, gpt_init, make_train_step

    for dtype, t, tol in VS_CPU_RUNS:
        cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layers=2,
                                  dtype=getattr(torch, dtype))
        params = gpt_init(cfg, torch.Generator().manual_seed(2), "cpu")
        tokens = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, t + 1), dtype=np.int64)
        batch = (torch.from_numpy(tokens[:, :-1]),
                 torch.from_numpy(tokens[:, 1:]))
        row = compare_states(step_card_vs_cpu(
            lambda dev: make_train_step(cfg, device=dev), params, batch))
        emit("train_vs_cpu", config="gpt2_small width, 2 layers",
             dtype=dtype, batch=2, seq=t, tol=tol, **row)
        check_vs_cpu("train_vs_cpu", dtype, row, tol)
        torch.cuda.empty_cache()


def profile_step(train_step, state, batch, phase: str, what: str) -> None:
    """Device time by kernel group over one train step after a warm-up
    step, and the device's idle share of that step's wall time."""
    state, m = train_step(state, batch)  # warm-up
    float(m["loss"])

    def one_step():
        _, out = train_step(state, batch)
        float(out["loss"])

    profile_device(one_step, phase, what)


def phase_train_profile():
    """Device time by kernel group over one GPT-2-small train step (the
    preset: remat on, B=16, S=1024), and the device's idle share of that
    step's wall time."""
    import torch

    from ray_tpu_torch.models import GPTConfig, make_train_step

    cfg = GPTConfig.gpt2_small()
    init_state, train_step = make_train_step(cfg)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    profile_step(train_step, state, token_batch(cfg.vocab_size, 16, 1024),
                 "train_profile",
                 "make_train_step, gpt2_small, remat, 16x1024, 1 step")
    del state
    torch.cuda.empty_cache()


def phase_llama_train(peaks):
    """make_llama_train_step(LlamaConfig.tpu_bench()) at B=8, S=2048, bf16,
    remat off (the preset), timed as phase_train; then one step under
    torch.profiler. MFU counts every param, the embedding and the untied
    head included, as bench.py does."""
    import torch

    from ray_tpu_torch.models import LlamaConfig, make_llama_train_step
    from ray_tpu_torch.models.convert import tree_leaves

    cfg = LlamaConfig.tpu_bench()
    b, s = 8, 2048
    init_state, train_step = make_llama_train_step(cfg)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    n_params = llama_param_count(cfg)
    check(n_params == sum(p.numel() for p in tree_leaves(state["params"])),
          "llama_param_count disagrees with the params")
    batch = token_batch(cfg.vocab_size, b, s)
    losses, steps_s, launches = timed_steps(train_step, state, batch)
    step = statistics.median(steps_s)
    expected = expected_launches(cfg.n_layers, cfg.remat)
    row = {"config": "llama tpu_bench", "remat": cfg.remat, "batch": b,
           "seq": s, "dtype": "bfloat16", "params": n_params,
           "step_ms_runs": [t * 1e3 for t in steps_s],
           "step_ms_median": step * 1e3, "tokens_per_s": b * s / step,
           "mfu": 6 * n_params * b * s / step / peaks["bf16"],
           "mfu_peak": f"bf16 {peaks['bf16']:.4g} FLOP/s "
                       f"({peaks['matched']})",
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": launches,
           "expected_launches": expected}
    emit("llama_train", **row)
    check_training("llama_train", losses, launches, expected)
    profile_step(train_step, state, batch, "llama_profile",
                 "make_llama_train_step, tpu_bench, 8x2048, 1 step")
    del state, batch
    torch.cuda.empty_cache()
    return row


def phase_llama_vs_cpu():
    """One llama step at tpu_bench width (8 heads of 128, 2 KV heads) with
    2 layers and B=2, card vs CPU from the same weights: the GQA gradient
    through K2 and K3 at head_dim 128, in train_vs_cpu's bands."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import (LlamaConfig, llama_init,
                                      make_llama_train_step)

    for dtype, t, tol in VS_CPU_RUNS:
        cfg = dataclasses.replace(LlamaConfig.tpu_bench(), n_layers=2,
                                  dtype=getattr(torch, dtype))
        params = llama_init(cfg, torch.Generator().manual_seed(4), "cpu")
        tokens = np.random.default_rng(4).integers(
            0, cfg.vocab_size, (2, t + 1), dtype=np.int64)
        batch = (torch.from_numpy(tokens[:, :-1]),
                 torch.from_numpy(tokens[:, 1:]))
        row = compare_states(step_card_vs_cpu(
            lambda dev: make_llama_train_step(cfg, device=dev), params,
            batch))
        emit("llama_vs_cpu", config="llama tpu_bench width, 2 layers",
             dtype=dtype, batch=2, seq=t, tol=tol, **row)
        check_vs_cpu("llama_vs_cpu", dtype, row, tol)
        torch.cuda.empty_cache()


def phase_vit():
    """make_vit_train_step(ViTConfig.vit_b16()) at B=64 on 224x224x3
    images, remat on (the preset), timed as phase_train; then
    make_classifier over the trained params on 64 images: the median of
    5 calls, each ending in the host's copy of the classes, with the
    launches of exactly one call."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import (ViTConfig, make_classifier,
                                      make_vit_train_step)
    from ray_tpu_torch.ops import _kernels

    cfg = ViTConfig.vit_b16()
    b = 64
    init_state, train_step = make_vit_train_step(cfg)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(5)
    images = rng.standard_normal(
        (b, cfg.image_size, cfg.image_size, cfg.channels)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, b, dtype=np.int64)
    batch = (torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda())
    losses, steps_s, launches = timed_steps(train_step, state, batch)
    step = statistics.median(steps_s)
    expected = expected_launches(cfg.n_layers, cfg.remat)
    seq = cfg.num_patches + 1
    row = {"config": "vit_b16", "remat": cfg.remat, "batch": b, "seq": seq,
           "dtype": "bfloat16", "step_ms_runs": [t * 1e3 for t in steps_s],
           "step_ms_median": step * 1e3, "images_per_s": b / step,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": launches,
           "expected_launches": expected}
    emit("vit_train", **row)
    check_training("vit_train", losses, launches, expected)

    predict = make_classifier(cfg, params=state["params"])
    predict(images)  # warm-up
    reset_launches()
    t0 = time.perf_counter()
    classes = predict(images)
    walls = [time.perf_counter() - t0]
    classify_launches = dict(_kernels.LAUNCHES)
    for _ in range(4):
        t0 = time.perf_counter()
        predict(images)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    expected_classify = expected_launches(cfg.n_layers, cfg.remat, False)
    emit("vit_classify", config="vit_b16", batch=b,
         wall_ms_runs=[w * 1e3 for w in walls], wall_ms_median=wall * 1e3,
         images_per_s=b / wall, launches=classify_launches,
         expected_launches=expected_classify)
    check(isinstance(classes, np.ndarray) and classes.shape == (b,)
          and 0 <= classes.min() and classes.max() < cfg.num_classes,
          f"classes out of range: {classes}")
    check(classify_launches == expected_classify,
          f"vit_classify launches {classify_launches}, "
          f"want {expected_classify}")
    del state, batch, predict
    torch.cuda.empty_cache()
    return {"vit_train": launches, "vit_classify": classify_launches}


def record_routes(record):
    """Wrap parallel.moe's top2_gating so that every call appends the
    experts each token was dispatched to (the [tokens, experts] mask of
    its kept routes, after capacity drops) to ``record``; returns the
    original to restore."""
    from ray_tpu_torch.parallel import moe as pmoe

    original = pmoe.top2_gating

    def recorded(logits, capacity):
        dispatch, combine, aux = original(logits, capacity)
        record.append(dispatch.any(-1).cpu())
        return dispatch, combine, aux

    pmoe.top2_gating = recorded
    return original


def phase_moe():
    """make_moe_train_step(MoEConfig()) at B=8, S=1024, bf16, remat on
    (the preset), timed as phase_train; then one f32 step at 2 layers,
    B=2, S=64, card vs CPU from the same weights: loss, gradients and
    params in train_vs_cpu's f32 bands, and the share of routed tokens
    whose two experts differ."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import MoEConfig, make_moe_train_step, moe_init
    from ray_tpu_torch.parallel import moe as pmoe

    cfg = MoEConfig()
    b, s = MOE_SHAPE[0], MOE_SHAPE[2]
    init_state, train_step = make_moe_train_step(cfg)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    batch = token_batch(cfg.vocab_size, b, s)
    losses, steps_s, launches = timed_steps(train_step, state, batch)
    step = statistics.median(steps_s)
    expected = expected_launches(cfg.n_layers, cfg.remat)
    row = {"config": "moe default", "remat": cfg.remat, "batch": b,
           "seq": s, "dtype": "bfloat16", "experts": cfg.n_experts,
           "step_ms_runs": [t * 1e3 for t in steps_s],
           "step_ms_median": step * 1e3, "tokens_per_s": b * s / step,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": launches,
           "expected_launches": expected}
    emit("moe_train", **row)
    check_training("moe_train", losses, launches, expected)
    del state, batch
    torch.cuda.empty_cache()

    tol = VS_CPU_RUNS[0][2]  # the f32 bands
    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = moe_init(small, torch.Generator().manual_seed(6), "cpu")
    tokens = np.random.default_rng(6).integers(
        0, small.vocab_size, (2, 65), dtype=np.int64)
    small_batch = (torch.from_numpy(tokens[:, :-1]),
                   torch.from_numpy(tokens[:, 1:]))
    record = []
    original = record_routes(record)
    try:
        states = step_card_vs_cpu(
            lambda dev: make_moe_train_step(small, device=dev), params,
            small_batch)
    finally:
        pmoe.top2_gating = original
    # The card's step ran first, then the CPU's, each calling the layers
    # in the same order (the forward, then the remat recompute).
    half = len(record) // 2
    card, cpu = torch.stack(record[:half]), torch.stack(record[half:])
    flips = float((card != cpu).any(-1).float().mean())
    dropped = float((cpu.sum(-1) < 2).float().mean())
    cmp = compare_states(states)
    emit("moe_vs_cpu", config="moe default width, 2 layers",
         dtype="float32", batch=2, seq=64, tol=tol,
         route_flip_share=flips, route_tol=TOL_MOE_ROUTE_FLIPS,
         dropped_route_share=dropped,
         routes_compared=int(card.shape[0] * card.shape[1]), **cmp)
    check_vs_cpu("moe_vs_cpu", "float32", cmp, tol)
    check(flips <= TOL_MOE_ROUTE_FLIPS,
          f"moe_vs_cpu: {flips} of the tokens routed to other experts")
    torch.cuda.empty_cache()
    return launches


def phase_resnet():
    """make_predictor(ResNetConfig.resnet50()) on 64 host images at 224:
    images/s over the median of 5 calls, each ended by the host's copy of
    the classes; then the f32 logits of 4 images, card vs CPU, from the
    same weights."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import (ResNetConfig, make_predictor,
                                      resnet_forward, resnet_init)
    from ray_tpu_torch.models.convert import params_to

    cfg = ResNetConfig.resnet50()
    images = np.random.default_rng(7).standard_normal(
        (64, 224, 224, 3)).astype(np.float32)
    predict = make_predictor(cfg,
                             generator=torch.Generator().manual_seed(7))
    predict(images).cpu()  # warm-up: cuDNN's algorithm choice
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        classes = predict(images).cpu()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = resnet_init(f32, torch.Generator().manual_seed(8), "cpu")
    few = torch.from_numpy(images[:4])
    card_params = params_to(params, "cuda")
    with torch.inference_mode():
        card = resnet_forward(card_params, few.cuda(), f32)
        cpu = resnet_forward(params, few, f32)
        # The control: TF32 convolutions and head, which the band must
        # tell from f32.
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = resnet_forward(card_params, few.cuda(), f32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    err = _norm_err(card.cpu(), cpu, 0.0)
    tf32_err = _norm_err(tf32.cpu(), cpu, 0.0)
    same = bool(torch.equal(card.argmax(-1).cpu(), cpu.argmax(-1)))
    emit("resnet", config="resnet50", batch=64, image_size=224,
         dtype="bfloat16", wall_ms_runs=[w * 1e3 for w in walls],
         wall_ms_median=wall * 1e3, images_per_s=64 / wall,
         vs_cpu={"images": 4, "dtype": "float32", "max_norm_err": err,
                 "tol": TOL_RESNET_F32_NORM, "argmax_equal": same,
                 "tf32_control_max_norm_err": tf32_err})
    check(classes.shape == (64,) and 0 <= int(classes.min())
          and int(classes.max()) < cfg.num_classes, "classes out of range")
    check(bool(torch.isfinite(card).all()), "non-finite ResNet logits")
    check(err <= TOL_RESNET_F32_NORM,
          f"ResNet-50 f32 logits card vs CPU differ by {err}")
    check(tf32_err > TOL_RESNET_F32_NORM,
          f"the ResNet band {TOL_RESNET_F32_NORM} passes TF32 logits "
          f"({tf32_err}): it cannot tell them from f32")
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
    over_limit = phase_heads_over_limit(peaks)
    serving = phase_slice()
    phase_online()
    phase_runtime()
    pool_actor = phase_control_plane()
    trained = phase_train(peaks)
    train_dp = phase_train_dp(peaks, trained[True]["losses"])
    phase_train_vs_cpu()
    phase_train_profile()
    llama = phase_llama_train(peaks)
    phase_llama_vs_cpu()
    vit = phase_vit()
    moe = phase_moe()
    phase_resnet()

    # Launches on each main path, each counted over exactly its run:
    # the batch serving slice, the same stage's call inside a Data pool
    # actor (counted in that process), one GPT-2-small train step with
    # remat (the preset) and one without, the 5 steps of the Train
    # worker (counted in its process), one llama, ViT and MoE train step
    # each, and one ViT classifier call.
    pool = {name: pool_actor[name] for name in serving}
    paths = {"serving": serving, "processor_pool_actor": pool,
             "train": trained[True]["launches"],
             "train_no_remat": trained[False]["launches"],
             "train_dp_worker": train_dp["launches"],
             "llama_train": llama["launches"], **vit, "moe_train": moe}
    by_path = {name: {path: launches[name]
                      for path, launches in paths.items()}
               for name in serving}
    slice_row = compared[(GPT2_SHAPE, "bfloat16", True)]
    llama_row = compared[(LLAMA_SHAPE, "bfloat16", True)]
    vit_row = compared[(VIT_SHAPE, "bfloat16", False)]
    moe_row = compared[(MOE_SHAPE, "bfloat16", True)]
    emit("flash_fwd_llama_shape", **llama_row)
    bwd_row = compared_bwd[(GPT2_SHAPE, "bfloat16", True)]
    bwd_llama = compared_bwd[(LLAMA_SHAPE, "bfloat16", True)]
    bwd_vit = compared_bwd[(VIT_SHAPE, "bfloat16", False)]
    bwd_moe = compared_bwd[(MOE_SHAPE, "bfloat16", True)]
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
        **{key: {"shape": row["shape"], "causal": row["causal"],
                 "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"],
                 "max_abs_err": row["max_abs_err"]}
           for key, row in (("llama_shape", llama_row),
                            ("vit_shape", vit_row),
                            ("moe_shape", moe_row))},
        "over_limit": [{key: row[key] for key in (
            "shape", "causal", "bh", "chunks", "launches", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "fwd_max_abs_err",
            "fwd_max_norm_err")} for row in over_limit],
    }]
    for name, key, grads, line in (("flash_bwd_dq", "dq", ("dq",), 233),
                                   ("flash_bwd_dkv", "dkv", ("dk", "dv"),
                                    280)):
        extra = {"max_delta_err": max(r["delta_err"]
                                      for r in compared_bwd.values())} \
            if name == "flash_bwd_dq" else {}
        extra["over_limit"] = [
            {"shape": row["shape"], "bh": row["bh"],
             "chunks": row["chunks"], "launches": row["launches"][name],
             "max_norm_err": {g: row["bwd_max_norm_err"][g] for g in grads},
             **row[key], "library_ms": row["bwd_library_ms"]}
            for row in over_limit if "bwd_max_norm_err" in row]
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
            **{shape_key: {
                "shape": row["shape"], "causal": row["causal"],
                "ms": row[key]["ms"], "plain_ms": row[key]["plain_ms"],
                "bound_ms": row[key]["bound_ms"],
                "bound_by": row[key]["bound_by"],
                "library_ms": row["library_ms"],
                "max_abs_err": max(row["max_abs_err"][g] for g in grads)}
               for shape_key, row in (("llama_shape", bwd_llama),
                                      ("vit_shape", bwd_vit),
                                      ("moe_shape", bwd_moe))},
            **extra,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
