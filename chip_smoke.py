#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the port's kernels from ``ray_tpu_torch/ops/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
drives the port's serving paths (in process, and hosted by the port's own
control plane: Serve's build_llm_app and Data's Processor, also on a
node daemon that holds the card, on one the autoscaler launches, and on
a node of a cluster the CLI starts, driven through the client link) and
its train steps at full width (GPT-2 small, the llama bench shape,
ViT-B/16, the MoE decoder; GPT-2 small also in Tune trials), the
ResNet-50 predictor, the libraries (Tune, the dashboard, Workflow, Jobs,
Pool) and RLlib (PPO, SAC, TD3, CQL, DreamerV3 and the rest), and prints
one JSON line per phase:

  1. device         the card (nvidia-smi name and power limit), torch, CUDA
  2. build          kernel build seconds and ptxas's register, spill and
                    shared-memory report per kernel, with its performance
                    notes (wgmma serialised, setmaxnreg ignored), and each
                    kernel's design read from its machine code; fails if
                    a bf16 kernel (K1-K3, the RMSNorm kernels, the qkv
                    split's) spills
                    or a bf16 K1, K2 or K3 is not
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
     compare_norm   the RMSNorm kernels (rms_norm_fwd, rms_norm_bwd,
                    rms_norm_dw) through rms_norm's autograd vs the plain
                    version's, forward, dx and dw, at the main paths'
                    shapes (GPT-2 small's [65536, 768], ViT-B/16's
                    [100864, 768] and its strided CLS rows [512, 768],
                    generation's [131072, 768] under inference_mode,
                    llama's [16384, 1024]), in f32 and at the layouts'
                    edges; one launch of each a call, and dx and dw
                    bit-identical over two backward calls; kernel,
                    bound, plain and torch.nn.functional.rms_norm times
     compare_qkv_rope  the qkv split's kernels (qkv_rope_fwd, qkv_rope_bwd)
                    through qkv_heads' autograd vs the plain chain's
                    (split, reshape, transpose, rope, .contiguous()):
                    q, k, v and d(qkv) bit for bit at GPT-2 small's B=64
                    step, generation's 128 x 1024 bucket (forward under
                    inference_mode), a tp=2 rank's heads, head_dim 128,
                    f32 and the layouts' edges; one launch of each a
                    call; kernel, bound and plain chain times
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
     dag_fused      the same greedy step as a two-node fused DAG
                    (gpt_forward, argmax) under compile_fused(jit=True):
                    one CUDA graph captured per input signature (capture
                    seconds), 8 greedy steps as replays whose tokens must
                    equal the slice's, K1 12 times a replay by the fused
                    callable's count and by torch.profiler's (a trace
                    with no device event at all is taken again, at most
                    3 takes); eager and replay ms at B=16, T=1024 and at
                    B=1, T=128
  7. online         LLMEngine and ContinuousBatchingEngine at GPT-2-small
                    width: time to first token, decode tokens/s, and the
                    KV-cache logits against a full forward
  8. runtime        ray_tpu_torch.init(num_cpus=4, num_gpus=1): a task,
                    an actor, put/get of 64 MB; a 64 MB bf16 CUDA tensor
                    put by the driver and read back as an equal CPU
                    tensor by the driver and by a task that sees no card
                    (put and get timed), and a CUDA tensor nested in a
                    dict read by that task as a CPU tensor; after shutdown the
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
     multinode      the processor's pipeline with its GPT stage on a node
                    daemon: a head with num_gpus=0 and one daemon node
                    (Cluster.add_node(daemon=True, num_gpus=1)) that holds
                    the card; the seed-0 GPT-2-small weights (247 MB,
                    bf16) put by the driver and pulled by the stage's pool
                    actor across the transfer plane; that actor on the
                    daemon node, in the daemon's process group, with 96
                    K1 launches there and none in the driver, its tokens
                    equal to the in-process stage's; a 64 MB bf16 CUDA
                    tensor drawn in a num_gpus=1 task on the daemon node,
                    read here as an equal CPU tensor; after remove_node no
                    process or directory of the daemon left and the
                    card's memory given back: join, pull (GB/s), stage
                    and get seconds
     autoscale      AutoscalerV2 over a head with num_gpus=0 and one node
                    type {"CPU": 4, "GPU": 1}: a num_gpus=1 task running
                    flash_attention at GPT-2's [16,12,1024,64] causal
                    bf16 brings up a port daemon with the card, runs
                    there (K1 launched in its process, its output within
                    TOL_BF16_NORM of mha_reference), and once idle past 3
                    s and a 1 s grace the node is drained and terminated
                    and the daemon's process group is gone: seconds from
                    submit to registration and to the result, and from
                    idle to termination
     cli_client     a cluster the CLI starts: a head (python -m
                    ray_tpu_torch start, RTT_NUM_GPUS=0) and one node
                    (start --address) that detects the card; status and
                    list nodes through the client address (GPU 1, two
                    alive nodes); this process as a client driver
                    (util.client.connect) submits the GPT stage (GPT-2
                    small, seed-0 weights, 16 prompts, 8 steps) as a
                    num_gpus=1 task, cold then warm: on the CLI's node,
                    pinned to one card, 96 K1 launches in its worker,
                    tokens equal to the in-process stage's; a 64 MB bf16
                    CUDA tensor nested in a dict as a task's argument,
                    reaching it as a CPU tensor with the driver's sum;
                    no process of the head holding a context on the card
                    or any NVIDIA device file (its /proc fds and maps,
                    the stage's worker the control);
                    util.multiprocessing.Pool with one actor pinned to the
                    card running K1 at GPT-2's shape on 4 seeded inputs
                    within TOL_BF16_NORM, 4 launches there; after SIGINT
                    to the head and SIGTERM to the node, no process or
                    directory of either left and the card's memory back:
                    head start, node join, connect, stage call, tensor
                    trip, Pool and teardown times
 11. train         make_train_step(GPTConfig.gpt2_small()) at B=16,
                    S=1024, bf16, remat on (the preset) and off: step ms,
                    tokens/s, MFU, peak memory, the losses, and K1, K2, K3
                    launches counted over exactly one step; one more step
                    each traced, whose GEMM launches must be equal (the
                    remat recompute runs no product)
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
     train_feed     the slice: make_vit_train_step(ViTConfig.vit_b16())
                    (remat) in a TorchTrainer worker pinned to the card,
                    fed by get_dataset_shard("train").iter_torch_batches(
                    device="cuda", device_prefetch=2) from data.from_numpy
                    of 6 x 64 seeded images zipped with their labels
                    (231 MB in the store): a warm-up step and 5 timed
                    steps, K1/K2/K3 launched 120/60/60 in the worker's
                    process, every batch on cuda:0 equal to its host rows,
                    the losses bit-identical to the same steps in process;
                    the fed step against a step on a batch already on the
                    card; a profiling.trace of one fed step (it must name
                    K1-K3, an empty trace taken again over the next step
                    as in dag_fused; its host-to-device copies' bytes, ms
                    and the share overlapping a kernel); device_memory_stats
                    against torch's peak; a CUDA tensor the worker puts,
                    read back equal by the driver
     libraries      the port's Tune, dashboard, Workflow and Jobs on a
                    head that declares the card (num_gpus=1): a sweep of
                    phase 11's GPT-2-small step (remat, B=16, S=1024,
                    seed-0 weights and batch) over lr 6e-4 and 0,
                    one trial at a time, each trial an actor pinned to
                    the card ({"CPU": 1, "GPU": 1}) under ASHA (max_t 8,
                    grace 2, reduction 2) with FailureConfig(
                    max_failures=1); the first trial checkpoints its state
                    (params and AdamW moments, torch.save) after step 4,
                    fails once, and resumes there: its step-1 loss against
                    phase 11's, its steps 5-8 against the same 8 steps
                    run here without a break; the lr-0 trial cut at a
                    rung, the best an lr > 0 trial that reached step 8;
                    K1/K2/K3 launched 24/12/12 a step in each trial's
                    process; the dashboard's cluster_status read by each
                    trial while it holds the card (GPU 0 of 1 free) and
                    after the sweep (1 of 1), /metrics as Prometheus
                    text; the card's free memory back after the sweep; a
                    durable workflow whose num_gpus=1 step 1 runs K1 at
                    GPT-2's shape and returns its CUDA output (persisted
                    through the store as a CPU tensor) and whose step 2
                    fails once: resume finishes it with no K1 launch,
                    equal to the same workflow run without a break; a job
                    that prints torch.cuda.is_available() in its
                    entrypoint (recorded: its supervisor holds no GPU),
                    and one stopped while it runs. Cold start, step,
                    checkpoint write and restore, and sweep seconds
     parallel       the parallel strategies on 2 ranks sharing the card,
                    each a process of one gloo world (parallel.launch.
                    RankPool on cuda:0; NCCL takes one rank a GPU), at
                    GPT-2 small's width: 3 steps each of the tp=2 and
                    fsdp=2 train steps (B=8, S=1024, remat) against the
                    tp=1 step in this process from the same weights
                    (losses, and the params gathered to the JAX layout),
                    Ulysses sp=2 with flash_attention at [16,12,1024,64]
                    forward and backward against flash_attention on the
                    whole tensors, ring attention sp=2 at [8,12,1024,64]
                    against mha_reference, the expert-parallel moe_layer
                    at MoEConfig()'s width (8192 tokens) forward and
                    backward against the one-device layer on each rank's
                    tokens, GPipe and 1F1B with 2 stages of 6 GPT-2
                    blocks and 4 microbatches of 2 x 1024 against the 12
                    blocks in sequence; the Megatron family steps, 3
                    bf16 steps each against the unsplit step in this
                    process from the same weights: llama tpu_bench at
                    tp=2 (B=4, S=2048, one kv head a rank), ViT-B/16 at
                    tp=2 (B=32), MoEConfig() at tp=2 and at ep=2 (B=8,
                    S=1024), with their blocks' shapes, then 2 f32 steps
                    at 2 layers held to the unsplit f32 step (loss,
                    gradients, moves, MoE's routes) with planted faults
                    the gradient band must reject; and
                    dryrun_multichip's rank work (in the same ranks);
                    K1-K3 counted in each rank's process against the
                    per-rank expectation, each collective's calls, bytes
                    a step (the tp, fsdp and family bytes against their
                    reckoning from the shapes) and transport (gloo, or
                    gloo host-staged for the point-to-point hops), and
                    each path's ms beside its tp=1 or one-device
                    counterpart
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
 21. rllib          the port's RLlib on its own control plane (one
                    cluster for this and the next two): PPO with
                    the Catalog's default CNN (5 convs 16-256, 2304 ->
                    256, 1.29M params) on 84x84x4 frames of a numpy
                    env with 6 actions, the learner on the card and 2
                    zero-GPU runners of 256 steps, 3 iterations of 16
                    updates (minibatch 128): ms per update, the shares
                    of sampling and learning, env steps/s; after each
                    weight sync (and one sync of the learner's CUDA
                    params themselves) the runners' value predictions
                    against the driver's forward on the same weights;
                    the gradients of one 128-frame minibatch card vs CPU
                    (f32, no TF32) within TOL_RLLIB_GRADS, and two
                    planted layout faults outside it; then one
                    iteration each of recurrent PPO (LSTM 128),
                    MultiAgentPPO (2 policies), IMPALA, APPO, DQN with
                    prioritized replay, BC and MARWIL on a numpy
                    CartPole; every loss finite, every learner's params
                    on the card, and no K1-K3 launch
     rllib_offpolicy  SAC and TD3 on a numpy Pendulum-v1 (the configs'
                    batch of 256 and (64, 64) width, 13,636 params), the
                    learner on the card and 1 zero-GPU runner of 200
                    steps, learning_starts 256, 3 iterations of 16
                    updates; then CQL for an iteration from a
                    SampleWriter dataset of SAC's samples: ms per update
                    (each ended by a synchronize), the shares of sampling
                    and learning; card vs CPU on one batch with the same
                    weights and noise (SAC's and CQL's gradients, CQL's
                    penalty's own, TD3's params after two steps in Adam
                    steps) within their bands, and a planted fault each
                    outside them; no K1-K3 launch
     dreamer        DreamerV3 at the JAX package's default width (256
                    deterministic, 8 x 8 categoricals, hidden 256, CNN
                    depth 16, 41 bins, 8 sequences of 16, horizon 15;
                    2,351,124 params) on 64x64x3 frames of a numpy env
                    with 6 actions, the learner on the card and 1
                    zero-GPU runner of 64 steps, learning_starts cut to
                    128 so that 2 of 3 iterations train: update ms
                    (median, min), its share of the iteration, the
                    losses, the runner's seconds a step; one update's
                    world-model, actor and critic gradients card vs CPU
                    within TOL_DREAMER_GRADS, the categorical samples
                    that flip between them, and three planted faults
                    outside the band; no K1-K3 launch
     phase_seconds  each phase's seconds and the script's total so far
 22. kernels        one entry per kernel: launches on each main path
                    (the processor's counted in its pool actor, the
                    Train workers' in their processes, the Tune trials'
                    summed over theirs, the fused DAG's replays by its
                    own count), error,
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

import contextlib
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
# RMSNorm kernels vs the plain version's forward and autograd backward,
#   after dividing by max|ref|: y and dx are f32 values rounded once to
#   the input dtype on both sides, from sums taken in other orders (warp
#   shuffles vs torch's reductions), so a bf16 value may round the other
#   way: a rounding step of bf16 (2**-8 = 3.9e-3) twice over; in f32 a
#   few ulps of the sums. dw is an f32 sum over every row in another
#   order (the kernels' fixed two-level order vs torch's).
TOL_NORM_BF16 = 8e-3
TOL_NORM_F32 = 1e-5
TOL_NORM_DW = 1e-4

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
# The attention of each rank of the parallel phase's Megatron family
# paths at tp=2 (llama's one kv head a rank, ViT-B/16's 6 heads at B=32,
# MoE's 4 heads; MoE at ep=2 runs MOE_SHAPE): both compare phases hold
# K1-K3 there, untimed.
PAR_FAMILY_SHAPES = [((4, 4, 2048, 128), True), ((32, 6, 197, 64), False),
                     ((8, 4, 1024, 64), True)]
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


def queued_ms(fn, iters: int = 20) -> float:
    """Per-call ms of ``iters`` calls queued back to back between two CUDA
    events, after a warm-up: the card's time wherever the card, not the
    host's wrapper, paces the calls."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Per-call device ms of ``fn``: ``iters`` calls captured in one CUDA
    graph, whose replays are timed by CUDA events (median of ``replays``),
    so no host time is counted, however short the kernel. The capture
    adds its calls to the wrappers' launch counts."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
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
    if k:
        return f"{k.group(1)}<{k.group(2)}>"
    # The RMSNorm kernels: <dtype, vectors a thread>; dw has no template.
    k = re.search(r"(rms_norm_(?:fwd|bwd))_kernelI(13__nv_bfloat16|f)"
                  r"Li(\d+)E", mangled)
    if k:
        dtype = "f32" if k.group(2) == "f" else "bf16"
        return f"{k.group(1)}_{dtype}_kernel<{k.group(3)}>"
    # The qkv split: <dtype>.
    k = re.search(r"(qkv_rope_(?:fwd|bwd))_kernelI(13__nv_bfloat16|f)E",
                  mangled)
    if k:
        dtype = "f32" if k.group(2) == "f" else "bf16"
        return f"{k.group(1)}_{dtype}_kernel"
    return "rms_norm_dw_f32_kernel" if "rms_norm_dw_kernel" in mangled \
        else mangled


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
         for shape, causal in MODEL_SHAPES + EDGE_CASES + PAR_FAMILY_SHAPES]
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
    return launches, {"params": stage._params, "tokens": batch["tokens"],
                      "generated": news}


def left_pad(token_lists, length: int, vocab: int):
    """Token lists left-padded with zeros to [len, length] int64, each
    cut to its last ``length`` tokens mod ``vocab``: what
    GPTInferenceStage does to its bucket."""
    import numpy as np

    out = np.zeros((len(token_lists), length), np.int64)
    for i, t in enumerate(token_lists):
        t = np.asarray(t)[-length:] % vocab
        out[i, length - len(t):] = t
    return out


def greedy_dag(params, cfg):
    """GPT's forward and greedy argmax as a two-node pure-function DAG:
    tokens [B, T] -> the next token of each row [B]."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import gpt_forward

    @rt.remote
    def forward(tokens):
        return gpt_forward(params, tokens, cfg)

    @rt.remote
    def greedy(logits):
        return logits[:, -1, :].argmax(dim=-1)

    with InputNode() as inp:
        return greedy.bind(forward.bind(inp))


def greedy_run(step, tokens, steps: int):
    """``steps`` greedy steps of ``step`` (tokens -> next tokens), each
    sliding the window by one token as GPTInferenceStage does; the new
    tokens [B, steps]."""
    import torch

    news = []
    for _ in range(steps):
        nxt = step(tokens)
        tokens = torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)
        news.append(nxt)
    return torch.stack(news, dim=1)


# The dag_fused phase: the serving slice's bucket, and a short prompt's
# prefill where launches dominate.
DAG_STEPS = 8
DAG_SIZES = [(16, 1024), (1, 128)]


def phase_dag_fused(slice_ctx):
    """The serving slice's greedy step as a fused DAG on the card:
    gpt_forward and argmax, compile_fused(jit=True), at phase_slice's
    bucket (B=16, T=1024) and at B=1, T=128. The first call of each
    signature warms up and captures its CUDA graph (timed); then
    DAG_STEPS greedy steps run as replays with the kernels' launches
    counted over exactly that run: K1 once a layer a replay, carried by
    the fused callable. The tokens must equal phase_slice's eager ones.
    torch.profiler must count the same K1 launches over one replay
    (take_trace: an empty trace is taken again over another replay).
    Eager (the same DAG, jit=False) and replay ms at both sizes."""
    import torch

    from ray_tpu_torch.llm import TokenizeStage
    from ray_tpu_torch.models import GPTConfig
    from ray_tpu_torch.ops import _kernels

    cfg = GPTConfig.gpt2_small()
    dag = greedy_dag(slice_ctx["params"], cfg)
    fused, eager = dag.compile_fused(jit=True), dag.compile_fused(jit=False)
    tokenize = TokenizeStage(max_length=cfg.max_seq_len)
    rows, launches = [], None
    for b, t in DAG_SIZES:
        lists = slice_ctx["tokens"] if (b, t) == (16, 1024) else \
            tokenize({"prompt": _prompts(b, t - 28, t)})["tokens"]
        tokens = torch.from_numpy(left_pad(lists, t, cfg.vocab_size)).cuda()
        fused(tokens)  # warm-up and capture
        torch.cuda.synchronize()
        key = list(fused.capture_s)[-1]  # this size's signature
        capture_s = fused.capture_s[key]
        per_replay = dict(fused.graphs[key].launches)
        reset_launches()
        with torch.no_grad():
            replayed = greedy_run(fused, tokens, DAG_STEPS).cpu()
        counted = dict(_kernels.LAUNCHES)
        with torch.no_grad():
            eager_tokens = greedy_run(eager, tokens, DAG_STEPS).cpu()
        profiled = take_trace(lambda: (fused(tokens),
                                       torch.cuda.synchronize()))
        with torch.no_grad():
            eager_ms = cuda_ms(lambda: eager(tokens))
        replay_ms = cuda_ms(lambda: fused(tokens))
        row = {"batch": b, "seq": t, "steps": DAG_STEPS,
               "capture_s": capture_s, "graphs": len(fused.graphs),
               "per_replay_launches": per_replay,
               "launches": counted,
               "profiled_k1": profiled["kernels"]["flash_fwd"],
               "empty_traces": profiled["empty_traces"],
               "eager_ms": eager_ms, "replay_ms": replay_ms,
               "replay_speedup": eager_ms / replay_ms,
               "tokens_equal_eager_dag": bool(torch.equal(replayed,
                                                           eager_tokens))}
        if (b, t) == (16, 1024):
            want = torch.from_numpy(slice_ctx["generated"]).long()
            row["tokens_equal_slice"] = bool(torch.equal(replayed, want))
            launches = counted
        rows.append(row)
    for row in rows:
        emit("dag_fused", **row)
    failed = dag_checks(rows, cfg.n_layers)
    check(not failed, f"dag_fused checks failed: {failed}")
    del fused, eager, dag
    torch.cuda.empty_cache()
    return launches


def dag_checks(rows, n_layers: int) -> list:
    """The names of the dag_fused checks that fail: K1 once a layer and
    rms_norm_fwd once a norm a replay by the callable's count (K1 also by
    the profiler's), and no backward kernel; DAG_STEPS replays counted;
    the replayed tokens equal to the eager DAG's and, at the slice's
    bucket, to phase_slice's; one graph per size."""
    forward = expected_launches(n_layers, False, train=False)
    failed = []
    for i, r in enumerate(rows):
        name = f"{r['batch']}x{r['seq']}"
        if r["per_replay_launches"] != {k: n for k, n in forward.items()
                                        if n}:
            failed.append(f"{name}: per-replay launches")
        if r["profiled_k1"] != n_layers:
            failed.append(f"{name}: profiler K1 count {r['profiled_k1']}, "
                          f"want {n_layers} ({r.get('empty_traces')} empty "
                          "traces)")
        if r["launches"] != {k: n * r["steps"] for k, n in forward.items()}:
            failed.append(f"{name}: launches over the replays")
        if not r["tokens_equal_eager_dag"]:
            failed.append(f"{name}: tokens vs the eager DAG")
        if r.get("tokens_equal_slice") is False:
            failed.append(f"{name}: tokens vs phase_slice")
        if r["graphs"] != i + 1:
            failed.append(f"{name}: graphs cached")
    if not any("tokens_equal_slice" in r for r in rows):
        failed.append("the slice's bucket was not run")
    return failed


# torch.profiler (torch 2.11 with CUPTI 12.8 on an H100) now and then hands
# back a trace that holds the host's runtime calls but none of the device's
# events, not even a copy outside any graph, for work that ran; such a
# trace counts nothing and is taken again, at most this many times.
TRACE_TAKES = 3


def take_trace(run, dir=None) -> dict:
    """trace_summary of a profiling.trace over ``run()``, which must end
    in a device sync. A trace that holds no device event at all is taken
    again over another ``run()``, at most TRACE_TAKES times; one with
    device events is kept, whatever it counts. ``empty_traces`` is the
    number of takes that came back empty."""
    import tempfile

    from ray_tpu_torch.util import profiling

    for take in range(1, TRACE_TAKES + 1):
        with tempfile.TemporaryDirectory(prefix="rtt_trace_",
                                         dir=dir) as logdir:
            with profiling.trace(logdir):
                run()
            summary = trace_summary(trace_file(logdir))
        if summary["device_events"]:
            break
    summary["empty_traces"] = take - bool(summary["device_events"])
    return summary


def trace_file(logdir: str) -> str:
    """The one Chrome trace that profiling.trace wrote into ``logdir``."""
    names = [n for n in os.listdir(logdir) if n.endswith(".pt.trace.json")]
    check(len(names) == 1, f"traces in {logdir}: {names}")
    return os.path.join(logdir, names[0])


# The port's kernels by the name their trace events carry.
TRACE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "rms_norm_fwd", "rms_norm_bwd", "rms_norm_dw",
                 "qkv_rope_fwd", "qkv_rope_bwd")
# The categories of a trace's events that ran on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def overlap_share(copies, kernels) -> float:
    """The share of the copies' time, (start, end) each, during which a
    kernel ran; None without copies."""
    copy_time = union_length(copies)
    if not copy_time:
        return None
    both = [(max(a, c), min(b, d)) for a, b in copies for c, d in kernels
            if max(a, c) < min(b, d)]
    return union_length(both) / copy_time


def trace_summary(path: str) -> dict:
    """From a Chrome trace of torch.profiler: launches of each port
    kernel (K1-K3) and of the GEMM kernels (``_kernel_group``'s matmul
    names), the number of events that ran on the card (kernels, copies,
    memsets), the device kernels' busy ms, and the host-to-device
    copies' count, bytes, ms and the share of their time that overlaps
    a kernel."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]

    def spans(evs):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in evs]

    return {
        "kernels": {k: sum(k in e.get("name", "") for e in kernels)
                    for k in TRACE_KERNELS},
        "gemm_launches": sum(_kernel_group(e.get("name", "")) == GEMM_GROUP
                             for e in kernels),
        "device_events": sum(e.get("cat") in DEVICE_CATS for e in events),
        "kernel_busy_ms": union_length(spans(kernels)) / 1e3,
        "htod_copies": len(copies),
        "htod_bytes": sum(int(e.get("args", {}).get("bytes", 0))
                          for e in copies),
        "htod_ms": union_length(spans(copies)) / 1e3,
        "htod_overlap_share": overlap_share(spans(copies), spans(kernels)),
    }


GEMM_GROUP = "matmul (cuBLAS)"


def _kernel_group(name: str) -> str:
    low = name.lower()
    for kernel, group in (("flash_fwd", "K1 flash_fwd (this port)"),
                          ("flash_bwd_dq", "K2 flash_bwd_dq (this port)"),
                          ("flash_bwd_dkv", "K3 flash_bwd_dkv (this port)")):
        if kernel in low:
            return group
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return GEMM_GROUP
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
         kernel_launches=sum(n for _, _, n in kernels),
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
    ] + [(shape, bf16, causal)
         for shape, causal in MODEL_SHAPES + EDGE_CASES + PAR_FAMILY_SHAPES]
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


# The RMSNorm cases, (name, shape of the tensor normed, dtype, what is
# normed, timed): "train" norms the whole tensor through forward and
# backward, "cls" its strided CLS rows x[:, 0] (ViT's final norm), "infer"
# the whole tensor's forward under inference_mode (generation). The
# main paths: GPT-2 small's B=64 train step (65,536 rows), ViT-B/16's B=512
# (100,864 rows), the generation stage's 128 x 1024 bucket, llama's bench
# step (D = 1,024); then f32 (the compare phases' f32 steps) and the
# layouts' edges: D = 64 (fewer vectors than lanes), 384 in f32 (several
# vectors a lane), 8,192 (a team of 8 warps a row, also strided) and one
# row.
NORM_CASES = [
    ("gpt", (64, 1024, 768), "bfloat16", "train", True),
    ("vit", (512, 197, 768), "bfloat16", "train", True),
    ("vit_cls", (512, 197, 768), "bfloat16", "cls", True),
    ("generation", (128, 1024, 768), "bfloat16", "infer", True),
    ("llama", (8, 2048, 1024), "bfloat16", "train", True),
    ("f32", (16, 1024, 768), "float32", "train", True),
    ("d64", (3, 5, 64), "bfloat16", "train", False),
    ("d384_f32", (7, 384), "float32", "train", False),
    ("d8192", (257, 8192), "bfloat16", "train", False),
    ("d8192_f32", (33, 3, 8192), "float32", "cls", False),
    ("one_row", (1, 1, 1024), "bfloat16", "train", False),
]


def norm_bound_ms(rows: int, d: int, dtype_bytes: int, bw: float,
                  tensors: int) -> float:
    """The least time of ``tensors`` [rows, d] read or written once: 2
    forward (x read, y written), 3 backward (x and dy read, dx written),
    so 10 bytes an element in bf16 for both. rstd, w and dw are under
    0.1% of them and left out."""
    return tensors * rows * d * dtype_bytes / bw * 1e3


def phase_compare_norm(peaks):
    """The RMSNorm kernels through ``rms_norm`` (its autograd Function on
    CUDA tensors) vs the plain version ``_rms_norm`` with autograd, at
    NORM_CASES: y, dx and dw within their bands, one launch of each kernel
    a call (no backward launch under inference_mode), dx and dw the same
    bits over two backward calls on the same inputs; at the timed cases
    the kernels' forward ms and backward ms (rms_norm_bwd and rms_norm_dw)
    by CUDA-graph replays (``graph_ms``: the wrappers' host time left out,
    as a step queued ahead of the card leaves it out), their byte bound,
    and, queued back to back (``queued_ms``), the plain version's forward
    + backward and torch.nn.functional.rms_norm's (never called by the
    port; its weight in x's dtype, as it takes one)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.layers import _rms_norm, rms_norm

    eps = 1e-6
    gen = torch.Generator(device="cuda").manual_seed(7)
    results = {}
    for name, shape, dtype_name, kind, timed in NORM_CASES:
        dtype = getattr(torch, dtype_name)
        full = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        d = shape[-1]
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")

        def normed(t):
            return t[:, 0] if kind == "cls" else t

        x = normed(full)
        g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        rows = x.numel() // d
        before = dict(_kernels.LAUNCHES)
        if kind == "infer":
            with torch.inference_mode():
                y = rms_norm(x, w, eps)
                y_ref = _rms_norm(x, w, eps)
        else:
            leaf, wk = full.clone().requires_grad_(), w.clone()
            y = rms_norm(normed(leaf), wk.requires_grad_(), eps)
            dx, dw = torch.autograd.grad(y, (leaf, wk), g)
        ran = {n: _kernels.LAUNCHES[n] - before[n]
               for n in ("rms_norm_fwd", "rms_norm_bwd", "rms_norm_dw")}
        want = {"rms_norm_fwd": 1, "rms_norm_bwd": int(kind != "infer"),
                "rms_norm_dw": int(kind != "infer")}

        def err(a, b):
            a, b = a.detach().float(), b.detach().float()
            return float((a - b).abs().max() / b.abs().max())

        tol = TOL_NORM_BF16 if dtype == torch.bfloat16 else TOL_NORM_F32
        row = {"case": name, "shape": list(x.shape), "rows": rows,
               "stride": x.reshape(-1, d).stride(0),
               "dtype": dtype_name, "kind": kind, "launches": ran,
               "tol": tol, "dw_tol": TOL_NORM_DW}
        finite = bool(torch.isfinite(y).all())
        if kind != "infer":
            ref_leaf, ref_w = full.clone().requires_grad_(), w.clone()
            y_ref = _rms_norm(normed(ref_leaf), ref_w.requires_grad_(), eps)
            dx_ref, dw_ref = torch.autograd.grad(y_ref, (ref_leaf, ref_w), g)
            row.update(dx_err=err(normed(dx), normed(dx_ref)),
                       dw_err=err(dw, dw_ref))
            finite = finite and bool(torch.isfinite(dx).all()) \
                and bool(torch.isfinite(dw).all())
            _, rstd = _kernels.rms_norm_fwd(x, w, eps)
            first = _kernels.rms_norm_bwd(x, w, rstd, g)
            again = _kernels.rms_norm_bwd(x, w, rstd, g)
            row["bit_identical"] = all(bool(torch.equal(a, b))
                                       for a, b in zip(first, again))
            del leaf, ref_leaf, dx, dx_ref, first, again
        row["y_err"] = err(y, y_ref)
        if timed:
            bw = peaks["bytes"]
            train = kind != "infer"
            row["fwd_ms"] = graph_ms(lambda: _kernels.rms_norm_fwd(
                x, w, eps))
            row["fwd_bound_ms"] = norm_bound_ms(rows, d, x.element_size(),
                                                bw, 2)
            w_lib = w.to(dtype)
            if train:
                row["bwd_ms"] = graph_ms(lambda: _kernels.rms_norm_bwd(
                    x, w, rstd, g))
                row["bwd_bound_ms"] = norm_bound_ms(
                    rows, d, x.element_size(), bw, 3)
                row["ms"] = row["fwd_ms"] + row["bwd_ms"]
                row["bound_ms"] = row["fwd_bound_ms"] + row["bwd_bound_ms"]
                xp = x.detach().clone().requires_grad_()
                wp = w.clone().requires_grad_()
                wl = w_lib.clone().requires_grad_()
                row["plain_ms"] = queued_ms(lambda: torch.autograd.grad(
                    _rms_norm(xp, wp, eps), (xp, wp), g), 5)
                row["library_ms"] = queued_ms(lambda: torch.autograd.grad(
                    F.rms_norm(xp, (d,), wl, eps), (xp, wl), g))
                del xp, wp, wl
            else:
                row["ms"], row["bound_ms"] = row["fwd_ms"], row["fwd_bound_ms"]
                with torch.inference_mode():
                    row["plain_ms"] = queued_ms(lambda: _rms_norm(x, w, eps),
                                                5)
                    row["library_ms"] = queued_ms(
                        lambda: F.rms_norm(x, (d,), w_lib, eps))
            row["bound_ratio"] = row["ms"] / row["bound_ms"]
        emit("compare_norm", **row)
        check(finite, f"non-finite RMSNorm kernel output at {name}")
        check(ran == want, f"{name}: launches {ran}, want {want}")
        check(row["y_err"] <= tol and row.get("dx_err", 0.0) <= tol
              and row.get("dw_err", 0.0) <= TOL_NORM_DW,
              f"the RMSNorm kernels disagree with the plain version: {row}")
        check(row.get("bit_identical", True),
              f"{name}: two backward calls differ")
        results[name] = row
        del full, x, g, y, y_ref
        torch.cuda.empty_cache()
    return results


# The qkv split cases, (name, (batch, seq, heads, head_dim), dtype, kind,
# timed): "train" runs qkv_heads forward and backward, "infer" its
# forward under inference_mode (generation). The main paths: GPT-2
# small's B=64 train step and the generation stage's 128 x 1024 bucket;
# then a tp=2 rank's 6 heads, head_dim 128, f32 (the compare phases' f32
# steps), and the layouts' edges: D = 16 (one lane a row), 48 (three
# lanes a row: 256 threads hold no whole number of rows), 256 in f32 (32
# lanes a row), one token, and more token tiles than gridDim.y's 65,535
# (8 rows a block at D = 256 in f32).
QKV_CASES = [
    ("gpt", (64, 1024, 12, 64), "bfloat16", "train", True),
    ("generation", (128, 1024, 12, 64), "bfloat16", "infer", True),
    ("tp_local", (64, 1024, 6, 64), "bfloat16", "train", True),
    ("d128", (8, 2048, 8, 128), "bfloat16", "train", True),
    ("f32", (16, 1024, 12, 64), "float32", "train", False),
    ("d16", (3, 129, 4, 16), "bfloat16", "train", False),
    ("d48", (2, 77, 5, 48), "bfloat16", "train", False),
    ("d256_f32", (2, 33, 3, 256), "float32", "train", False),
    ("one_token", (1, 1, 1, 64), "bfloat16", "train", False),
    ("tiles_over_limit", (1, 524296, 1, 256), "float32", "train", False),
]


def qkv_bound_ms(shape, dtype_bytes: int, bw: float) -> float:
    """The least time of the qkv split's forward, or of its backward: its
    3 B S h D elements read once and written once (4 bytes an element
    each way in bf16). The f32 [S, D/2] rope tables, read from L2, are
    under 1% of them at the model shapes and left out."""
    b, s, h, d = shape
    return 2 * 3 * b * s * h * d * dtype_bytes / bw * 1e3


def phase_compare_qkv_rope(peaks):
    """The qkv split's kernels through ``qkv_heads`` (its autograd
    Function on CUDA tensors) vs the plain chain ``_qkv_heads`` (split,
    reshape, transpose, ``_rope`` on q and k, ``.contiguous()`` on v) with
    autograd, both on the card, at QKV_CASES: q, k, v and d(qkv) the same
    bits (the largest difference recorded where they are not), one launch
    of each kernel a call (no backward under inference_mode); at the
    timed cases the forward's and the backward's ms by CUDA-graph replays
    (``graph_ms``), their byte bound each, and the plain chain's forward
    (+ backward) queued back to back (``queued_ms``)."""
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.layers import _qkv_heads, _rope_tables, qkv_heads

    gen = torch.Generator(device="cuda").manual_seed(11)
    names = ("qkv_rope_fwd", "qkv_rope_bwd")
    results = {}
    for name, shape, dtype_name, kind, timed in QKV_CASES:
        dtype = getattr(torch, dtype_name)
        b, s, h, d = shape
        train = kind != "infer"
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        grads = [torch.randn((b, h, s, d), generator=gen,
                             device="cuda").to(dtype) for _ in range(3)]
        before = dict(_kernels.LAUNCHES)
        if train:
            x, x_ref = qkv.clone().requires_grad_(), \
                qkv.clone().requires_grad_()
            got = qkv_heads(x, d)
            dx, = torch.autograd.grad(got, x, grads)
            ran = {n: _kernels.LAUNCHES[n] - before[n] for n in names}
            want = _qkv_heads(x_ref, d)
            dx_ref, = torch.autograd.grad(want, x_ref, grads)
        else:
            with torch.inference_mode():
                got = qkv_heads(qkv, d)
                ran = {n: _kernels.LAUNCHES[n] - before[n] for n in names}
                want = _qkv_heads(qkv, d)
        pairs = dict(zip("qkv", zip(got, want)))
        if train:
            pairs["dqkv"] = (dx, dx_ref)
        same = {key: bool(torch.equal(a.detach(), r.detach()))
                for key, (a, r) in pairs.items()}
        row = {"case": name, "shape": list(shape), "dtype": dtype_name,
               "kind": kind, "launches": ran, "bit_identical": same,
               "max_abs_diff": {
                   key: float((a.detach().float() - r.detach().float())
                              .abs().max()) if not same[key] else 0.0
                   for key, (a, r) in pairs.items()},
               "layout": all(t.is_contiguous() and tuple(t.shape)
                             == (b, h, s, d) for t in got),
               "finite": all(bool(torch.isfinite(a).all())
                             for a, _ in pairs.values())}
        del pairs, got, want
        if train:
            del x, x_ref, dx, dx_ref
        if timed:
            cos, sin = _rope_tables(s, d, qkv.device)
            row["fwd_ms"] = graph_ms(lambda: _kernels.qkv_rope_fwd(
                qkv, d, cos, sin))
            row["bound_ms"] = qkv_bound_ms(shape, qkv.element_size(),
                                           peaks["bytes"])
            row["fwd_bound_ratio"] = row["fwd_ms"] / row["bound_ms"]
            if train:
                row["bwd_ms"] = graph_ms(lambda: _kernels.qkv_rope_bwd(
                    *grads, cos, sin))
                row["bwd_bound_ratio"] = row["bwd_ms"] / row["bound_ms"]
                xp = qkv.clone().requires_grad_()
                row["plain_ms"] = queued_ms(lambda: torch.autograd.grad(
                    _qkv_heads(xp, d), xp, grads), 5)
                del xp
            else:
                with torch.inference_mode():
                    row["plain_ms"] = queued_ms(lambda: _qkv_heads(qkv, d),
                                                5)
        emit("compare_qkv_rope", **row)
        check(row["finite"], f"non-finite qkv split output at {name}")
        check(ran == {"qkv_rope_fwd": 1, "qkv_rope_bwd": int(train)},
              f"{name}: launches {ran}")
        check(row["layout"], f"{name}: q, k, v are not contiguous "
                             "[B, h, S, D]")
        check(all(same.values()),
              f"the qkv split's kernels differ from the plain chain: {row}")
        results[name] = row
        del qkv, grads
        torch.cuda.empty_cache()
    return results


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
    declared, a task, an actor, put/get of 64 MB; a 64 MB bf16 CUDA
    tensor put by the driver, read back as an equal CPU tensor by a task
    that sees no card and by the driver, and a CUDA tensor nested in a
    dict read by that task as a CPU tensor; after shutdown no session or
    store directory of the copy is left."""
    import numpy as np
    import torch

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
        del back

        @rt.remote
        def read_without_gpu(t):
            import torch
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    torch.cuda.is_available(), type(t).__name__, t)

        @rt.remote
        def read_nested_without_gpu(d):
            import torch
            t = d["t"]
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    torch.cuda.is_available(), type(t).__name__,
                    str(t.device), t)

        gen = torch.Generator(device="cuda").manual_seed(0)
        cuda_t = torch.randn(32 << 20, device="cuda", generator=gen,
                             dtype=torch.bfloat16)  # 64 MB
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = rt.put(cuda_t)
        cuda_put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        from_store = rt.get(ref, timeout=120)
        cuda_get_s = time.perf_counter() - t0
        visible, task_cuda, task_type, from_task = rt.get(
            read_without_gpu.remote(ref), timeout=120)
        host_t = cuda_t.cpu()
        # A tensor nested in a container (a dict of weights, as RLlib
        # syncs them to its runners) is brought to host by the pickler
        # too: the task without a card reads a CPU tensor.
        n_visible, n_cuda, n_type, n_device, n_t = rt.get(
            read_nested_without_gpu.remote({"t": cuda_t[:4]}), timeout=120)
        nested = {"cuda_visible_devices": n_visible, "cuda_available": n_cuda,
                  "type": n_type, "device": n_device,
                  "equal": torch.equal(n_t, host_t[:4])}
        tensor_rows = {
            "driver": {"device": str(from_store.device),
                       "dtype": str(from_store.dtype),
                       "equal": torch.equal(from_store, host_t)},
            "zero_gpu_task": {"cuda_visible_devices": visible,
                              "cuda_available": task_cuda,
                              "type": task_type,
                              "device": str(from_task.device),
                              "dtype": str(from_task.dtype),
                              "equal": torch.equal(from_task, host_t)}}
        del ref, from_store, from_task, n_t, cuda_t, host_t
        during = copy_dirs(node)
    finally:
        rt.shutdown()
    after = copy_dirs(node)
    emit("runtime", init_s=init_s, resources=resources, task=task,
         task_s=task_s, actor_calls_s=actor_s, put_get_64mb_s=put_get_s,
         put_get_equal=same, cuda_tensor_put_64mb_s=cuda_put_s,
         cuda_tensor_get_64mb_s=cuda_get_s, cuda_tensor=tensor_rows,
         nested_cuda_tensor_in_zero_gpu_task=nested,
         dirs_during=during, dirs_after=after)
    check(tensor_rows == {
        "driver": {"device": "cpu", "dtype": "torch.bfloat16",
                   "equal": True},
        "zero_gpu_task": {"cuda_visible_devices": "", "cuda_available":
                          False, "type": "Tensor", "device": "cpu",
                          "dtype": "torch.bfloat16", "equal": True}},
        f"a CUDA tensor through the store: {tensor_rows}")
    check(nested == {"cuda_visible_devices": "", "cuda_available": False,
                     "type": "Tensor", "device": "cpu", "equal": True},
          f"a CUDA tensor nested in a dict, read without a card: {nested}")
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


# The multinode and autoscale phases: a head that holds no GPU, and the
# card given to one node daemon (cluster_utils) or to one the autoscaler
# launches (autoscaler.v2). A daemon and its workers run in a process
# group of their own; the phases read what is left of them with
# _private/test_utils.py's group_members and owned_dirs.
MULTINODE_TENSOR_ELEMENTS = 32 << 20  # 64 MB of bf16
# Card memory the driver may see missing after the daemon is gone: its
# workers' CUDA contexts (about 500 MB each) must have been given back.
MULTINODE_MEMORY_SLACK = 64 << 20
AUTOSCALE_IDLE_S = 3.0
AUTOSCALE_GRACE_S = 1.0
AUTOSCALE_TIMEOUT = 240.0


def remote_weights_stage():
    """counting_stage()'s GPTInferenceStage, built from weights it pulls
    itself: ``weights`` is a list holding the put object (so nothing
    resolves it on the way), fetched in the pool actor's constructor and
    timed; the rows also carry the node and the process group the actor
    runs in."""
    counting = counting_stage()

    class RemoteWeightsStage(counting):
        def __init__(self, weights, **kwargs):
            import ray_tpu_torch as rt

            t0 = time.perf_counter()
            params = rt.get(weights[0], timeout=600)
            self._pull_s = time.perf_counter() - t0
            self._node = rt.get_runtime_context().get_node_id()
            super().__init__(params=params, **kwargs)

        def __call__(self, batch):
            out = super().__call__(batch)
            n = len(out[self._out])
            out["pull_s"] = [self._pull_s] * n
            out["stage_node"] = [self._node] * n
            out["stage_pgid"] = [os.getpgid(0)] * n
            return out

    return RemoteWeightsStage


def seeded_bf16(n: int, device: str):
    """``n`` bf16 normals drawn on ``device`` from seed 0."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(n, generator=gen, device=device, dtype=torch.bfloat16)


def make_tensor_on_node(n: int, device: str = "cuda"):
    """seeded_bf16(n) drawn on the card (``device``: the CPU in the
    tests), with the node and card of the process that drew it."""
    import ray_tpu_torch as rt

    t = seeded_bf16(n, device)
    return {"tensor": t, "node": rt.get_runtime_context().get_node_id(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def multinode_checks(m: dict) -> dict:
    """A multinode report against what the phase requires, by name: the
    card counted once, on the daemon; the GPT stage's pool actor on the
    daemon node, in a process of the daemon's group, with 96 K1 launches
    there and none in the driver, its tokens equal to the in-process
    stage's; the CUDA tensor drawn on the daemon node read by the driver
    as an equal CPU tensor; nothing of the daemon left after
    remove_node, and the card's memory given back."""
    expected = {name: n * PROCESSOR_STEPS for name, n in expected_launches(
        m["n_layers"], remat=False, train=False).items()}
    actor, tensor = m["pool_actor"], m["tensor"]
    return {
        "gpu_once": m["cluster_gpus"] == 1.0
        and m["gpus_by_node"] == {"head": 0.0, "daemon": 1.0},
        "daemon_process": m["daemon_pid"] != m["driver_pid"],
        "stage_on_daemon": actor["node"] == m["daemon_node"]
        and actor["pgid"] == m["daemon_pid"]
        and actor["pid"] not in (m["driver_pid"], m["daemon_pid"]),
        "launches": {k: actor[k] for k in expected} == expected,
        "driver_launches": set(m["driver_launches"].values()) == {0},
        "tokens_equal": m["equal_rows"] == m["rows"] == 16,
        "tensor": tensor == {"node": m["daemon_node"], "device": "cpu",
                             "dtype": "torch.bfloat16", "equal": True,
                             "cuda_visible_devices": "0"},
        "daemon_reaped": m["left_processes"] == [],
        "dirs_removed": m["dirs_during"] == 2 and m["left_dirs"] == [],
        "memory_back": m["card_free_after"] is not None
        and m["card_free_after"]
        >= m["card_free_before"] - MULTINODE_MEMORY_SLACK}


def card_free_bytes(device: str):
    """Free memory of the card after this process gave back its cache
    (None on the CPU, where the tests run the phase)."""
    import torch

    if device != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def phase_multinode(cfg=None, device: str = "cuda"):
    """phase_processor's pipeline with its GPT stage on a node daemon: a
    head started with num_gpus=0, so the card belongs to one daemon node
    (Cluster.add_node(daemon=True, num_gpus=1)); the GPT-2-small weights
    drawn here from seed 0 and put, so they cross from the head's store
    to the daemon's over the transfer plane; the stage's tokens against
    the in-process stage's (run first, so the card's free memory is
    read after this process's own growth); a 64 MB bf16 CUDA tensor
    drawn on the daemon node and read here; then remove_node, after
    which nothing of the daemon may be left. Returns the pool actor's
    launches. (``cfg`` and ``device`` are for the CPU tests, which run
    it at a tiny width.)"""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch._private.test_utils import group_members, owned_dirs
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.llm import (DetokenizeStage, GPTInferenceStage,
                                   Processor, StageSpec, TokenizeStage)
    from ray_tpu_torch.models import GPTConfig, gpt_init
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util import state as state_api

    cfg = cfg or GPTConfig.gpt2_small()
    prompts = _prompts(16, 600, 1024)
    stage_kwargs = {"config": cfg, "max_new_tokens": PROCESSOR_STEPS,
                    "device": device}
    params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    local = GPTInferenceStage(params=params, **stage_kwargs)
    batch = TokenizeStage(max_length=cfg.max_seq_len)({"prompt": prompts})
    local(batch)  # warm-up
    t0 = time.perf_counter()
    want = local(batch)["generated_tokens"]
    local_s = time.perf_counter() - t0
    del local
    here = seeded_bf16(MULTINODE_TENSOR_ELEMENTS, device).cpu()
    free_before = card_free_bytes(device)
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 4, "num_gpus": 0})
    head_node = cluster.head_node.node_id
    try:
        t0 = time.perf_counter()
        daemon = cluster.add_node(num_cpus=4, num_gpus=1, daemon=True)
        join_s = time.perf_counter() - t0
        daemon_pid = daemon.proc.pid
        resources = rt.cluster_resources()
        by_node = {row["node_id"]: row["resources_total"].get("GPU", 0.0)
                   for row in state_api.list_nodes()}
        weights = rt.put(params)
        processor = Processor([
            StageSpec(TokenizeStage, {"max_length": cfg.max_seq_len}),
            StageSpec(remote_weights_stage(),
                      {"weights": [weights], **stage_kwargs}, num_gpus=1),
            StageSpec(DetokenizeStage)], batch_size=16)
        reset_launches()
        t0 = time.perf_counter()
        rows = processor(data.from_items([{"prompt": p}
                                          for p in prompts])).take_all()
        pipeline_s = time.perf_counter() - t0
        driver_launches = dict(_kernels.LAUNCHES)
        worker = {name: int(rows[0]["launches_" + name])
                  for name in driver_launches}
        pid = int(rows[0]["stage_pid"])
        actor = {"pid": pid, "node": rows[0]["stage_node"],
                 "pgid": int(rows[0]["stage_pgid"]),
                 "pull_s": float(rows[0]["pull_s"]),
                 "stage_s": float(rows[0]["stage_s"]), **worker}
        check(len({r["stage_pid"] for r in rows}) == 1
              and {int(r["stage_call"]) for r in rows} == {1},
              "the GPT stage ran in more than one actor or call")

        by_prompt = {r["prompt"]: np.asarray(r["generated_tokens"])
                     for r in rows}
        equal = sum(bool(np.array_equal(by_prompt[p], w))
                    for p, w in zip(prompts, want))

        make = rt.remote(num_gpus=1)(make_tensor_on_node)
        ref = make.remote(MULTINODE_TENSOR_ELEMENTS, device)
        rt.wait([ref], timeout=300)
        t0 = time.perf_counter()
        made = rt.get(ref, timeout=300)
        tensor_get_s = time.perf_counter() - t0
        t = made["tensor"]
        tensor = {"node": made["node"], "device": str(t.device),
                  "dtype": str(t.dtype), "equal": torch.equal(t, here),
                  "cuda_visible_devices": made["cuda_visible_devices"]}
        del made, t, ref, weights
        dirs_during = len(owned_dirs(daemon_pid))
        t0 = time.perf_counter()
        cluster.remove_node(daemon)
        remove_s = time.perf_counter() - t0
        left_processes = group_members(daemon_pid)
        left_dirs = owned_dirs(daemon_pid)
    finally:
        cluster.shutdown()
    free_after = card_free_bytes(device)
    m = {"n_layers": cfg.n_layers, "daemon_node": daemon.node_id,
         "daemon_pid": daemon_pid,
         "driver_pid": os.getpid(), "join_s": join_s,
         "cluster_gpus": resources.get("GPU"),
         "gpus_by_node": {"head": by_node.get(head_node),
                          "daemon": by_node.get(daemon.node_id)},
         "weights_bytes": nbytes, "weights_pull_s": actor["pull_s"],
         "weights_pull_gb_per_s": nbytes / actor["pull_s"] / 1e9,
         "pipeline_s": pipeline_s, "stage_on_daemon_s": actor["stage_s"],
         "in_process_stage_s": local_s, "pool_actor": actor,
         "driver_launches": driver_launches, "rows": len(rows),
         "equal_rows": equal, "tensor": tensor,
         "tensor_bytes": MULTINODE_TENSOR_ELEMENTS * 2,
         "tensor_get_s": tensor_get_s, "remove_s": remove_s,
         "dirs_during": dirs_during, "left_processes": left_processes,
         "left_dirs": left_dirs, "card_free_before": free_before,
         "card_free_after": free_after}
    checks = multinode_checks(m)
    emit("multinode", **m, checks=checks)
    failed = [name for name, ok in checks.items() if not ok]
    check(not failed, f"multinode checks failed: {failed}")
    return worker


def attention_on_node(shape, causal: bool, device: str = "cuda",
                      seed: int = 0) -> dict:
    """K1 through flash_attention at ``shape`` (bf16, from ``seed``) on
    the card of the process this runs in (``device``: the CPU in the
    tests), against mha_reference on the same inputs: the error over the
    reference's largest magnitude, K1's launches in this process over the
    call, and where it ran."""
    return attention_run(shape, causal, device, seed)[1]


def attention_run(shape, causal: bool, device: str = "cuda", seed: int = 0):
    """attention_on_node's call: (K1's output, its report)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import _kernels, flash_attention
    from ray_tpu_torch.ops.attention import mha_reference

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    before = dict(_kernels.LAUNCHES)
    out = flash_attention(q, k, v, causal=causal)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {name: n - before.get(name, 0)
                for name, n in _kernels.LAUNCHES.items()}
    ref = mha_reference(q, k, v, causal, 1.0 / math.sqrt(shape[-1]))
    err = float((out.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    return out, {
        "max_norm_err": err, "finite": bool(torch.isfinite(out).all()),
        "launches": launches, "pid": os.getpid(), "pgid": os.getpgid(0),
        "node": rt.get_runtime_context().get_node_id(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def autoscale_checks(m: dict) -> dict:
    """An autoscale report against what the phase requires, by name."""
    task = m["task"]
    return {
        "one_daemon": m["launched"] == 1 and m["daemon_gpus"] == 1.0,
        "task_on_daemon": task["node"] == m["daemon_node"]
        and task["pgid"] == m["daemon_pid"]
        and task["cuda_visible_devices"] == "0",
        "k1_launched": task["launches"].get("flash_fwd", 0) >= 1,
        "k1_in_band": task["finite"]
        and task["max_norm_err"] <= TOL_BF16_NORM,
        "scaled_down": m["final_statuses"] == {"TERMINATED": 1}
        and m["gpus_after"] is None,
        "daemon_exited": m["daemon_exit"] is not None
        and m["left_processes"] == []}


def phase_autoscale(shape=GPT2_SHAPE, device: str = "cuda"):
    """AutoscalerV2 over a head with no GPU: a num_gpus=1 task that runs
    flash_attention at GPT-2's shape brings up a port daemon with the
    card; the task runs there against mha_reference; once idle past the
    timeout and its grace, the node is drained and terminated. Returns
    the task's launches. (``shape`` and ``device`` are for the CPU
    tests.)"""
    import subprocess

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.config import ray_config
    from ray_tpu_torch._private.test_utils import group_members
    from ray_tpu_torch.autoscaler.v2 import (RAY_RUNNING, RAY_STOPPING,
                                             TERMINATED, AutoscalerV2)
    from ray_tpu_torch.util import state as state_api

    rt.init(num_cpus=4, num_gpus=0)
    saved_grace = ray_config.scale_down_idle_grace_s
    ray_config.set("scale_down_idle_grace_s", AUTOSCALE_GRACE_S)
    scaler = AutoscalerV2(
        {"gpu": {"resources": {"CPU": 4, "GPU": 1}, "max_workers": 1}},
        max_workers=1, idle_timeout_s=AUTOSCALE_IDLE_S, interval_s=0.5)
    try:
        scaler.start()
        task = rt.remote(num_gpus=1)(attention_on_node)
        t0 = time.perf_counter()
        ref = task.remote(shape, True, device)
        deadline = t0 + AUTOSCALE_TIMEOUT
        inst = None
        while inst is None or inst.status != RAY_RUNNING:
            check(time.perf_counter() < deadline
                  and (inst is None or inst.status != TERMINATED),
                  "no daemon registered for the GPU demand")
            time.sleep(0.05)
            live = list(scaler.manager.instances.values())
            inst = live[0] if live else None
        register_s = time.perf_counter() - t0
        daemon_pid = inst.handle["proc"].pid
        daemon_gpus = next((row["resources_total"].get("GPU")
                            for row in state_api.list_nodes()
                            if row["node_id"] == inst.node_id_hex), None)
        result = rt.get(ref, timeout=AUTOSCALE_TIMEOUT)
        result_s = time.perf_counter() - t0
        t_idle = time.perf_counter()
        while inst.status in (RAY_RUNNING, RAY_STOPPING):
            check(time.perf_counter() < t_idle + AUTOSCALE_TIMEOUT,
                  "the idle node was not scaled down")
            time.sleep(0.05)
        proc = inst.handle["proc"]
        try:
            exit_code = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            exit_code = None
        down_s = time.perf_counter() - t_idle
        statuses = scaler.manager.status_counts()
        launched = len(scaler.manager.instances)
        gpus_after = rt.cluster_resources().get("GPU")
    finally:
        scaler.stop()
        ray_config.set("scale_down_idle_grace_s", saved_grace)
        rt.shutdown()
    m = {"daemon_node": inst.node_id_hex, "daemon_pid": daemon_pid,
         "daemon_gpus": daemon_gpus, "launched": launched, "task": result,
         "submit_to_register_s": register_s,
         "submit_to_result_s": result_s, "idle_to_terminated_s": down_s,
         "idle_timeout_s": AUTOSCALE_IDLE_S, "grace_s": AUTOSCALE_GRACE_S,
         "final_statuses": statuses, "gpus_after": gpus_after,
         "daemon_exit": exit_code,
         "left_processes": group_members(daemon_pid),
         "tol": TOL_BF16_NORM}
    checks = autoscale_checks(m)
    emit("autoscale", **m, checks=checks)
    failed = [name for name, ok in checks.items() if not ok]
    check(not failed, f"autoscale checks failed: {failed}")
    return result["launches"]


# The cli_client phase: a cluster started by the CLI (a head that holds
# no GPU, and one node that detects the card), driven from this process
# through the client link; then Pool on the card in this process's own
# runtime. Each CLI process starts a process group of its own, so its
# workers are counted by group_members after teardown.
CLI_TIMEOUT = 120.0
CLI_TEARDOWN_S = 60.0
POOL_INPUTS = 4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_head_banner(lines) -> dict:
    """The addresses and token the CLI's head prints when it has started
    (``python -m ray_tpu_torch start``): keys client, cluster, token and
    dashboard, each present once its line has been printed."""
    keys = {"client": "client address", "cluster": "cluster address",
            "token": "cluster token", "dashboard": "dashboard"}
    out = {}
    for line in lines:
        for key, label in keys.items():
            m = re.match(rf"\s*{label}:\s+(\S+)", line)
            if m:
                out[key] = m.group(1)
    return out


def parse_status(text: str) -> dict:
    """``status``'s output: {resource: [available, total]} and the count
    of alive nodes."""
    out = {"resources": {}, "nodes": None}
    for line in text.splitlines():
        m = re.match(r"\s*(\S+): (\S+)/(\S+) available$", line)
        if m:
            out["resources"][m.group(1)] = [float(m.group(2)),
                                            float(m.group(3))]
        m = re.match(r"\s*nodes: (\d+)$", line)
        if m:
            out["nodes"] = int(m.group(1))
    return out


class CliProcess:
    """A ``python -m ray_tpu_torch`` process in a process group of its
    own, its output read by a thread until it closes (so a full pipe
    never blocks it)."""

    def __init__(self, args, env: dict):
        import threading

        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", *args], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)
        self.pid = self.proc.pid
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, done, timeout: float = CLI_TIMEOUT) -> float:
        """Seconds until ``done(lines)`` holds; fails if the process ends
        first or the deadline passes."""
        t0 = time.perf_counter()
        while not done(self.lines):
            check(self.proc.poll() is None,
                  f"CLI process exited {self.proc.returncode}: "
                  f"{self.lines[-20:]}")
            check(time.perf_counter() - t0 < timeout,
                  f"CLI process printed no more within {timeout} s: "
                  f"{self.lines[-20:]}")
            time.sleep(0.02)
        return time.perf_counter() - t0

    def stop(self, sig, timeout: float):
        """Send ``sig``; the exit code, or None if it outlived ``timeout``
        (then it and its group are killed)."""
        import signal

        self.proc.send_signal(sig)
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(self.pid, signal.SIGKILL)
            self.proc.wait(timeout=30)
            return None


def cli_env(**keys) -> dict:
    """This process's environment for a CLI process, with ``keys`` set
    (None removes a key) and the checkout on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for key, value in keys.items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = str(value)
    return env


def run_cli(args, env: dict) -> tuple:
    """One short CLI command: (exit code, its standard output)."""
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT)
    return out.returncode, out.stdout


def client_stage_call(cfg, prompts, steps: int, device: str = "cuda"):
    """What the client submits as a num_gpus=1 task: the GPT stage at
    ``cfg``'s width built from seed-0 weights (drawn on the CPU, as
    phase_multinode draws them) on ``device``, called once on
    ``prompts`` with K1's launches counted in this process
    (counting_stage); with where it ran."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import TokenizeStage
    from ray_tpu_torch.models import gpt_init

    t0 = time.perf_counter()
    params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    stage = counting_stage()(params=params, config=cfg,
                             max_new_tokens=steps, device=device)
    build_s = time.perf_counter() - t0
    out = stage(TokenizeStage(max_length=cfg.max_seq_len)(
        {"prompt": prompts}))
    return {"tokens": [np.asarray(t) for t in out["generated_tokens"]],
            "launches": {k[len("launches_"):]: int(v[0])
                         for k, v in out.items()
                         if k.startswith("launches_")},
            "pid": os.getpid(), "pgid": os.getpgid(0),
            "node": rt.get_runtime_context().get_node_id(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "build_s": build_s, "stage_s": float(out["stage_s"][0])}


def sum_on_card(payload, device: str = "cuda") -> dict:
    """What the client's tensor task runs: the device the nested tensor
    arrived on, and its f32 sum on ``device``."""
    import ray_tpu_torch as rt

    t = payload["x"]
    return {"arrived_on": str(t.device), "dtype": str(t.dtype),
            "sum": float(t.to(device).float().sum()),
            "node": rt.get_runtime_context().get_node_id(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def cuda_files(pid: int) -> dict:
    """The NVIDIA device files a process has open or mapped: cuInit opens
    /dev/nvidiactl, /dev/nvidia<N> and /dev/nvidia-uvm, and a context
    maps /dev/nvidia-uvm too (``import torch`` alone maps libcuda and
    opens none). nvidia-smi's compute apps cannot say this: in a
    container it lists processes by host pids."""
    fds, maps = set(), set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                fds.add(target)
        with open(f"/proc/{pid}/maps") as f:
            for line in f:
                if "/dev/nvidia" in line:
                    maps.add(line.split()[-1])
    except OSError:
        pass
    return {"fds": sorted(fds), "maps": sorted(maps)}


def one_card_id(visible) -> bool:
    return isinstance(visible, str) and re.fullmatch(r"\d+", visible) \
        is not None


def cli_client_checks(m: dict) -> dict:
    """A cli_client report against what the phase requires, by name: the
    CLI's status shows the card once, on the node, and two alive nodes;
    both stage calls through the client ran on the CLI's node, in its
    process group, pinned to one card, with 96 K1 launches each and the
    in-process stage's tokens; the CUDA tensor reached the task as a CPU
    tensor with the driver's sum; no process of the head has opened the
    card (while the stage's worker, the control, maps it); Pool's K1 outputs in the band, 4 launches in one pool
    actor; nothing of either CLI process left, and the card's memory
    back."""
    expected = {name: n * PROCESSOR_STEPS for name, n in expected_launches(
        m["n_layers"], remat=False, train=False).items()}
    calls, tensor, pool = m["stage_calls"], m["tensor"], m["pool"]
    head_pids = set(m["head_group"])
    return {
        "cli_status": m["status"]["resources"].get("GPU", [None])[1] == 1.0
        and m["status"]["nodes"] == 2 and m["listed_alive"] == 2
        and m["gpus_by_node"] == {"head": 0.0, "node": 1.0}
        and m["status_rc"] == m["list_rc"] == 0,
        "stage_on_node": len(calls) == 2 and all(
            c["node"] == m["node_id"] and c["pgid"] == m["node_pid"]
            and c["pid"] not in head_pids | {m["driver_pid"], m["node_pid"]}
            and one_card_id(c["cuda_visible_devices"]) for c in calls),
        "launches": all(c["launches"] == expected for c in calls),
        "tokens_equal": all(c["equal_rows"] == c["rows"] == 16
                            for c in calls),
        "tensor": tensor["arrived_on"] == "cpu"
        and tensor["dtype"] == "torch.bfloat16"
        and tensor["sum"] == m["driver_sum"]
        and tensor["node"] == m["node_id"]
        and one_card_id(tensor["cuda_visible_devices"]),
        "head_no_context": m["head_cuda_files"] == {}
        and "/dev/nvidia-uvm" in m["worker_cuda_files"]["maps"],
        "pool_in_band": len(pool["rows"]) == POOL_INPUTS and all(
            r["finite"] and r["max_norm_err"] <= TOL_BF16_NORM
            for r in pool["rows"]),
        "pool_launches": {k: n for k, n in pool["launches"].items() if n}
        == {"flash_fwd": POOL_INPUTS}
        and len(pool["pids"]) == 1 and m["driver_pid"] not in pool["pids"]
        and all(one_card_id(r["cuda_visible_devices"])
                for r in pool["rows"]),
        "teardown": m["head_exit"] == 0 and m["node_exit"] == 0
        and m["dirs_during"] == {"head": 2, "node": 2}
        and m["left_processes"] == [] and m["left_dirs"] == [],
        "memory_back": m["card_free_after"] is not None
        and m["card_free_after"]
        >= m["card_free_before"] - MULTINODE_MEMORY_SLACK}


def pool_on_card(shape, device: str) -> dict:
    """util.multiprocessing.Pool in this process's own runtime, its one
    actor pinned to the card: K1 at ``shape`` on POOL_INPUTS seeded
    inputs against mha_reference (counted call), then the same map again
    (timed warm)."""
    import functools

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.multiprocessing import Pool

    rt.init(num_cpus=2, num_gpus=1)
    try:
        with Pool(processes=1, ray_remote_args={"num_gpus": 1}) as pool:
            run = functools.partial(attention_on_node, shape, True, device)
            t0 = time.perf_counter()
            rows = pool.map(run, range(POOL_INPUTS))
            cold_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            pool.map(run, range(POOL_INPUTS))
            warm_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rt.shutdown()
    launches = {}
    for r in rows:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return {"shape": list(shape), "rows": rows, "launches": launches,
            "pids": sorted({r["pid"] for r in rows}),
            "cold_ms": cold_ms, "warm_ms": warm_ms}


def phase_cli_client(cfg=None, device: str = "cuda", shape=GPT2_SHAPE):
    """A cluster the CLI starts: a head (``python -m ray_tpu_torch start``
    with RTT_NUM_GPUS=0) and one node (``start --address``) that detects
    the card; ``status`` and ``list nodes`` read through the client
    address; this process connects as a client driver and submits the GPT
    stage (phase_multinode's seed-0 weights, 16 prompts, 8 steps) as a
    num_gpus=1 task twice, cold then warm, against the in-process stage;
    a 64 MB bf16 CUDA tensor nested in a dict goes to a num_gpus=1 task
    through the link; then Pool on the card in this process's runtime;
    then SIGINT to the head and SIGTERM to the node, after which nothing
    of either may be left. Returns K1's launches on the client's path
    (the cold call, counted in the node's worker) and Pool's. (``cfg``,
    ``device`` and ``shape`` are for the CPU tests, which run it small;
    there the node's GPU is faked.)"""
    import signal

    import numpy as np
    import torch

    from ray_tpu_torch._private.test_utils import group_members, owned_dirs
    from ray_tpu_torch.llm import GPTInferenceStage, TokenizeStage
    from ray_tpu_torch.models import GPTConfig, gpt_init
    from ray_tpu_torch.util.client import connect

    t_phase = time.perf_counter()
    cfg = cfg or GPTConfig.gpt2_small()
    prompts = _prompts(16, 600, 1024)
    local = GPTInferenceStage(
        params=gpt_init(cfg, torch.Generator().manual_seed(0), "cpu"),
        config=cfg, max_new_tokens=PROCESSOR_STEPS, device=device)
    batch = TokenizeStage(max_length=cfg.max_seq_len)({"prompt": prompts})
    local(batch)  # warm-up
    t0 = time.perf_counter()
    want = local(batch)["generated_tokens"]
    local_s = time.perf_counter() - t0
    del local
    free_before = card_free_bytes(device)

    head = CliProcess(
        ["start", "--host", "127.0.0.1", "--port", str(free_port()),
         "--dashboard-port", str(free_port()), "--num-cpus", "2"],
        cli_env(RTT_NUM_GPUS=0))
    node = None
    m = {"n_layers": cfg.n_layers, "driver_pid": os.getpid(),
         "head_pid": head.pid, "in_process_stage_s": local_s,
         "card_free_before": free_before}
    try:
        m["head_start_s"] = head.wait_for(
            lambda lines: "dashboard" in parse_head_banner(lines))
        banner = parse_head_banner(head.lines)
        m["banner"] = banner
        # The node detects its GPUs; on the CPU one is faked.
        node = CliProcess(
            ["start", "--address", banner["cluster"],
             "--token-hex", banner["token"]],
            cli_env(RTT_NUM_GPUS=None if device == "cuda" else 1))
        m["node_pid"] = node.pid
        m["node_join_s"] = node.wait_for(
            lambda lines: any("node daemon joined" in x for x in lines))
        token_env = cli_env(RTT_CLUSTER_TOKEN_HEX=banner["token"])
        m["status_rc"], text = run_cli(
            ["status", "--address", banner["client"]], token_env)
        m["status"] = parse_status(text)
        m["list_rc"], text = run_cli(
            ["list", "nodes", "--address", banner["client"]], token_env)
        nodes = [n for n in json.loads(text) if n.get("alive", True)]
        m["listed_alive"] = len(nodes)
        m["node_id"] = next((n["node_id"] for n in nodes
                             if not n.get("is_head")), None)
        m["gpus_by_node"] = {
            ("head" if n.get("is_head") else "node"):
            n["resources_total"].get("GPU", 0.0) for n in nodes}
        m["dirs_during"] = {"head": len(owned_dirs(head.pid)),
                            "node": len(owned_dirs(node.pid))}

        t0 = time.perf_counter()
        conn = connect(banner["client"], token=banner["token"])
        m["connect_s"] = time.perf_counter() - t0
        try:
            stage_call = conn.remote(client_stage_call).options(num_gpus=1)
            calls = []
            for _ in ("cold", "warm"):
                t0 = time.perf_counter()
                out = conn.get(stage_call.remote(
                    cfg, prompts, PROCESSOR_STEPS, device),
                    timeout=CLI_TIMEOUT * 5)
                out["client_s"] = time.perf_counter() - t0
                got = out.pop("tokens")
                out["rows"] = len(got)
                out["equal_rows"] = sum(bool(np.array_equal(a, b))
                                        for a, b in zip(got, want))
                calls.append(out)
            m["stage_calls"] = calls

            x = seeded_bf16(MULTINODE_TENSOR_ELEMENTS, device)
            m["driver_sum"] = float(x.float().sum())
            summed = conn.remote(sum_on_card).options(num_gpus=1)
            t0 = time.perf_counter()
            m["tensor"] = conn.get(summed.remote({"x": x}, device),
                                   timeout=CLI_TIMEOUT)
            m["tensor_trip_s"] = time.perf_counter() - t0
            m["tensor_bytes"] = MULTINODE_TENSOR_ELEMENTS * 2
            del x
            m["head_group"] = group_members(head.pid)
            m["head_cuda_files"] = {
                pid: files for pid in m["head_group"]
                for files in [cuda_files(pid)] if files["fds"] or
                files["maps"]}
            m["worker_cuda_files"] = cuda_files(calls[-1]["pid"])
        finally:
            conn.close()

        m["pool"] = pool_on_card(shape, device)
    finally:
        t0 = time.perf_counter()
        m["head_exit"] = head.stop(signal.SIGINT, CLI_TEARDOWN_S)
        m["node_exit"] = node.stop(signal.SIGTERM, CLI_TEARDOWN_S) \
            if node is not None else None
        pids = [head.pid] + ([node.pid] if node is not None else [])
        deadline = time.perf_counter() + CLI_TEARDOWN_S
        while any(group_members(p) or owned_dirs(p) for p in pids) and \
                time.perf_counter() < deadline:
            time.sleep(0.05)
        m["teardown_s"] = time.perf_counter() - t0
        m["left_processes"] = [q for p in pids for q in group_members(p)]
        m["left_dirs"] = [d for p in pids for d in owned_dirs(p)]
    m["card_free_after"] = card_free_bytes(device)
    m["tol"] = TOL_BF16_NORM
    m["phase_s"] = time.perf_counter() - t_phase
    checks = cli_client_checks(m)
    emit("cli_client", **m, checks=checks)
    failed = [name for name, ok in checks.items() if not ok]
    check(not failed, f"cli_client checks failed: {failed}")
    return {"cli_client": m["stage_calls"][0]["launches"],
            "pool": m["pool"]["launches"]}


def reset_launches() -> None:
    from ray_tpu_torch.ops import _kernels

    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0


def expected_launches(n_layers: int, remat: bool, train: bool = True,
                      qkv: bool = True) -> dict:
    """K1, K2 and K3, the RMSNorm kernels' and the qkv split's launches
    over one train step (or, ``train=False``, one forward) of a model
    whose ``n_layers`` blocks each run one flash_attention and two
    rms_norms (and, with ``qkv``, one qkv_heads: GPT's and MoE's blocks,
    not llama's or ViT's), and a final rms_norm after them: K1 and the
    blocks' norm and split forwards in every layer's forward and, under
    remat, again when the checkpointed block is recomputed in the
    backward; K2, K3 and qkv_rope_bwd once a layer, rms_norm_bwd and
    rms_norm_dw once a norm, in the backward."""
    norms = 2 * n_layers + 1
    splits = n_layers if qkv else 0
    if not train:
        return {"flash_fwd": n_layers, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0, "rms_norm_fwd": norms,
                "rms_norm_bwd": 0, "rms_norm_dw": 0,
                "qkv_rope_fwd": splits, "qkv_rope_bwd": 0}
    return {"flash_fwd": n_layers * (2 if remat else 1),
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers,
            "rms_norm_fwd": norms + (2 * n_layers if remat else 0),
            "rms_norm_bwd": norms, "rms_norm_dw": norms,
            "qkv_rope_fwd": splits * (2 if remat else 1),
            "qkv_rope_bwd": splits}


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


def token_batch(vocab: int, b: int, s: int, seed: int = 0,
                device: str = "cuda"):
    """Random tokens on the card (``device``) and their next tokens
    (np.roll)."""
    import numpy as np
    import torch

    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                  dtype=np.int64)
    return (torch.from_numpy(tokens).to(device),
            torch.from_numpy(np.roll(tokens, -1, 1)).to(device))


def phase_train(peaks):
    """make_train_step(GPTConfig.gpt2_small()) at B=16, S=1024 on the
    card: 1 warm-up step, then 5 timed steps, each closed by fetching the
    loss; the kernels' launches counted over exactly the first timed
    step; then one more step traced for its GEMM launches. Remat on (the
    preset: JAX's dots_with_no_batch_dims_saveable, whose recompute runs
    no product), then off (what bench.py's bench_tpu times); the two
    steps' GEMM launches must be equal."""
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
        peak = torch.cuda.max_memory_allocated()
        traced = take_trace(lambda: (float(train_step(state, batch)[1]
                                           ["loss"]),
                                     torch.cuda.synchronize()))
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
               "max_memory_allocated_gb": peak / 1e9,
               "losses": losses, "launches": launches,
               "expected_launches": expected,
               "gemm_launches": traced["gemm_launches"],
               "traced_kernels": traced["kernels"],
               "empty_traces": traced["empty_traces"]}
        emit("train", **row)
        check_training("train", losses, launches, expected)
        results[remat] = row
        del state, batch
        torch.cuda.empty_cache()
    gemm = {remat: results[remat]["gemm_launches"] for remat in results}
    check(gemm[True] == gemm[False] > 0,
          f"train: GEMM launches a step, remat on {gemm[True]} and off "
          f"{gemm[False]}, must be equal")
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


# The train_feed phase: ViT-B/16 (remat, the preset) in a Train worker
# pinned to the card, its batches read through the device feed from a
# Dataset of FEED_BATCHES x FEED_BATCH images made from FEED_SEED: one
# warm-up step, then FEED_BATCHES - 1 timed steps.
FEED_BATCHES, FEED_BATCH, FEED_SEED = 6, 64, 11
# Elements of the CUDA tensor the worker puts for the driver to read.
FEED_PUT_ELEMENTS = 1 << 20


def feed_data(cfg, batches: int, b: int, seed: int):
    """(images [batches*b, H, W, C] f32 NHWC, labels [batches*b] int64)
    from numpy's generator seeded ``seed``: the Dataset's rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batches * b, cfg.image_size, cfg.image_size, cfg.channels),
        dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, batches * b, dtype=np.int64)
    return images, labels


def train_feed_loop(config):
    """train_loop_per_worker of the train_feed phase, in a worker pinned
    to the card: make_vit_train_step(vit_b16) fed by
    ``get_dataset_shard("train").iter_torch_batches(device="cuda",
    device_prefetch=2, drop_last=True)``: a warm-up step, then the timed
    steps, each from taking its batch off the feed to fetching its loss,
    the kernels' launches counted in this process over exactly those;
    each batch held against the host rows it came from (on the card,
    after its step); then as many steps on a batch already on the card;
    then a profiling.trace of one fed step inside the next epoch (its
    upload window busy), summarized here (take_trace: an empty trace is
    taken again over the next fed step); device_memory_stats against
    torch's peak; and a put of a CUDA tensor for the driver to read."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models import ViTConfig, make_vit_train_step
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util import profiling

    torch.backends.cuda.matmul.allow_tf32 = False  # as in the driver
    cfg = ViTConfig.vit_b16()
    n, b = config["batches"], config["batch"]
    images, labels = feed_data(cfg, n, b, config["seed"])
    host = (torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda())
    init_state, train_step = make_vit_train_step(cfg)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    shard = train.get_dataset_shard("train")

    def feed():
        return iter(shard.iter_torch_batches(
            batch_size=b, device="cuda", device_prefetch=2, drop_last=True))

    def step(batch):
        nonlocal state
        state, m = train_step(state, (batch["image"], batch["label"]))
        return float(m["loss"])  # the fetch ends the step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, fed_s, arrived = [], [], []
    batches = feed()
    for i in range(n):
        if i == 1:
            before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        batch = next(batches)
        losses.append(step(batch))
        if i:
            fed_s.append(time.perf_counter() - t0)
        rows = slice(i * b, (i + 1) * b)
        arrived.append({
            "devices": sorted({str(t.device) for t in batch.values()}),
            "equal": torch.equal(batch["image"], host[0][rows])
            and torch.equal(batch["label"], host[1][rows])})
        del batch
    launches = {k: _kernels.LAUNCHES[k] - before.get(k, 0)
                for k in _kernels.LAUNCHES}
    check(next(batches, None) is None, "the feed gave more batches")

    resident = {"image": host[0][:b], "label": host[1][:b]}
    resident_s = []
    for _ in range(n - 1):
        t0 = time.perf_counter()
        step(resident)
        resident_s.append(time.perf_counter() - t0)

    batches = feed()
    step(next(batches))
    traced = take_trace(lambda: (step(next(batches)),
                                 torch.cuda.synchronize()),
                        dir=config["storage"])
    del batches
    stats = profiling.device_memory_stats()
    put = rt.put(torch.arange(FEED_PUT_ELEMENTS, dtype=torch.float32,
                              device="cuda"))
    train.report({
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_count": torch.cuda.device_count(),
        "losses": losses, "launches": launches, "arrived": arrived,
        "fed_step_ms_runs": [t * 1e3 for t in fed_s],
        "fed_step_ms_median": statistics.median(fed_s) * 1e3,
        "resident_step_ms_runs": [t * 1e3 for t in resident_s],
        "resident_step_ms_median": statistics.median(resident_s) * 1e3,
        "images_per_s": b / statistics.median(fed_s),
        "traced_step": traced,
        "memory_stats": stats,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "put_ref": put})


def train_feed_checks(m: dict, reference, driver_pid: int, steps: int
                      ) -> dict:
    """A train_feed report against what the phase requires: the worker
    is another process that sees one card; K1, K2, K3 launched as
    ``steps`` ViT-B/16 steps with remat; every batch arrived on cuda:0
    equal to its host rows; the losses equal ``reference`` (the driver's
    in-process steps on the same batches), bit for bit; the trace names
    K1-K3 as one step launches them; device_memory_stats' peak is
    torch's."""
    expected = {k: v * steps for k, v in
                expected_launches(12, True, qkv=False).items()}
    ours, theirs = m["losses"], list(reference)
    traced = m["traced_step"]["kernels"]
    return {
        "expected_launches": expected,
        "loss_rel_errs": [abs(a - b) / abs(b) for a, b in zip(ours, theirs)],
        "checks": {
            "other_process": m["pid"] != driver_pid,
            "pinned": m["cuda_visible_devices"] == "0"
            and m["device_count"] == 1,
            "launches": m["launches"] == expected,
            "arrived_on_card": all(a["devices"] == ["cuda:0"]
                                   for a in m["arrived"]),
            "arrived_equal": len(m["arrived"]) == len(theirs)
            and all(a["equal"] for a in m["arrived"]),
            "losses_equal": ours == theirs
            and all(math.isfinite(x) for x in ours),
            "trace_names_kernels": traced == expected_launches(
                12, True, qkv=False),
            "memory_stats": m["memory_stats"].get("peak_bytes_in_use")
            == m["max_memory_allocated"] > 0}}


def phase_train_feed(peaks):
    """The slice: the ViT-B/16 step in a TorchTrainer worker pinned to
    the card, fed by the device feed from a Dataset in the store
    (data.from_numpy of the images, zipped with the labels). Its losses
    are held against the same steps in process on the same batches, its
    launches counted in its process; the fed step against a resident
    one, and the trace's host-to-device copies. The worker's put of a
    CUDA tensor is read back here."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.models import ViTConfig, make_vit_train_step
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = ViTConfig.vit_b16()
    n, b = FEED_BATCHES, FEED_BATCH
    images, labels = feed_data(cfg, n, b, FEED_SEED)
    init_state, train_step = make_vit_train_step(cfg)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    reference = []
    for i in range(n):
        rows = slice(i * b, (i + 1) * b)
        state, m = train_step(state, (torch.from_numpy(images[rows]).cuda(),
                                      torch.from_numpy(labels[rows]).cuda()))
        reference.append(float(m["loss"]))
    del state, m
    torch.cuda.empty_cache()

    storage = tempfile.mkdtemp(prefix="rtt_train_feed_")
    rt.init(num_cpus=4)
    node = current_node()
    try:
        t0 = time.perf_counter()
        ds = data.from_numpy(images, column="image",
                             override_num_blocks=n).zip(
            data.from_numpy(labels, column="label", override_num_blocks=n))
        result = TorchTrainer(
            train_feed_loop,
            train_loop_config={"batches": n, "batch": b, "seed": FEED_SEED,
                               "storage": storage},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="train_feed", storage_path=storage),
            datasets={"train": ds},
        ).fit()
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"train_feed failed: {result.error!r}")
        m = dict(result.metrics)
        put = rt.get(m.pop("put_ref"), timeout=120)
        store = {"capacity_mb": node.store.capacity / 1e6,
                 "used_mb_after_fit": node.store.used_bytes / 1e6}
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    got = train_feed_checks(m, reference, os.getpid(), n - 1)
    got["checks"]["worker_put_read_back"] = (
        isinstance(put, torch.Tensor) and put.device.type == "cpu"
        and torch.equal(put, torch.arange(FEED_PUT_ELEMENTS,
                                          dtype=torch.float32)))
    got["checks"]["no_dirs_left"] = copy_dirs(node) == []
    emit("train_feed", config="vit_b16", remat=cfg.remat, batch=b,
         batches=n, dtype="bfloat16", dataset_mb=(images.nbytes
                                                  + labels.nbytes) / 1e6,
         object_store=store,
         driver_pid=os.getpid(), fit_s=fit_s, reference_losses=reference,
         fed_vs_resident=m["fed_step_ms_median"]
         / m["resident_step_ms_median"], **got, **m)
    failed = [name for name, ok in got["checks"].items() if not ok]
    check(not failed, f"train_feed checks failed: {failed}")
    return m["launches"]


# The libraries phase: Tune, the dashboard, a durable workflow and a job
# on one cluster whose head declares the card (num_gpus=1). The sweep:
# phase_train's GPT-2-small step (remat, B=16, S=1024, seed-0 weights and
# batch) in trials pinned to the card, AdamW at each of TUNE_LRS (best
# first), one trial at a time under ASHA (max_t 8, grace 2, reduction 2:
# rungs at steps 2 and 4; at each rung a trial below the best half of
# those recorded there stops, so the lr-0 trial stops at step 2); the
# first trial fails once after its step-4 checkpoint and Tune restarts
# it from that checkpoint. Two trials: each trial's process costs its
# cold start, and one trial that runs through and one that ASHA stops
# are what the checks read.
TUNE_STEPS = 8
TUNE_LRS = [6e-4, 0.0]
TUNE_CHECKPOINT_AT = 4
# The resumed trial's steps against the same steps run uninterrupted in
# this process: the bf16 loss_rtol of test_torch_train.py. The restored
# bf16 params and moments are the saved ones to the bit; the embedding's
# backward sums its rows with atomics, in another order in each run.
TOL_TUNE_RESUME = 2e-3


def process_age_s() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start / os.sysconf("SC_CLK_TCK")


def read_cluster_status(url: str) -> dict:
    """The dashboard's /api/cluster_status: the GPUs it counts and the
    nodes."""
    import urllib.request

    with urllib.request.urlopen(url + "/api/cluster_status",
                                timeout=30) as resp:
        status = json.loads(resp.read())
    return {"gpu_total": status["resources_total"].get("GPU"),
            "gpu_available": status["resources_available"].get("GPU"),
            "nodes": status["nodes"]}


def tune_optimizer(lr: float):
    """The default step's AdamW at ``lr``."""
    import functools

    from ray_tpu_torch.models._training import default_optimizer

    return functools.partial(default_optimizer, lr=lr)


def train_state_digest(state) -> str:
    """state_digest over a train state whole: its step, its params and
    its optimizer's state (the AdamW moments and step counts), so a
    restore that drops any of them gives another digest."""
    import torch

    return state_digest({"step": torch.as_tensor(state["step"]),
                         "params": state["params"],
                         "opt": state["opt_state"].state_dict()["state"]})


def restore_trial_state(init_state, checkpoint, device) -> tuple:
    """A trial's train state from its ``checkpoint``, on ``device``: the
    params, the AdamW state and the step as saved. Returns the state and
    the seconds of the read and of the state's build."""
    t0 = time.perf_counter()
    saved = checkpoint.to_state(map_location=device)
    t1 = time.perf_counter()
    state = init_state(params=saved["params"])
    state["opt_state"].load_state_dict(saved["opt_state"])
    state["step"] = saved["step"]
    return state, {"restore_read_s": t1 - t0,
                   "restore_init_s": time.perf_counter() - t1}


def tune_gpt_trial(config, cfg=None, device="cuda", batch=(16, 1024),
                   marker=None, dashboard=None):
    """A trial of the libraries phase, in its own actor process: the
    GPT-2-small step with AdamW at ``config["lr"]``, from the seed-0
    weights on the seed-0 batch (or from the trial's checkpoint, which
    Tune hands back on a restart, loaded onto this process's card), for
    TUNE_STEPS steps, each closed by fetching the loss and reported, the
    kernels' launches counted in this process over each step. After step
    TUNE_CHECKPOINT_AT it checkpoints the state (the params and both
    AdamW moments); the first trial to find no ``marker`` then raises,
    once. Each step appends a row to progress.jsonl in the trial's
    directory; the first step of each process also reads the dashboard
    while this trial holds the card. (``cfg``, ``device`` and ``batch``
    are for the CPU tests.)"""
    entered, age = time.perf_counter(), process_age_s()
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models import GPTConfig, make_train_step
    from ray_tpu_torch.ops import _kernels

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the trial sees no card")
    torch.backends.cuda.matmul.allow_tf32 = False  # as in the driver
    cfg = cfg or GPTConfig.gpt2_small()
    init_state, train_step = make_train_step(
        cfg, optimizer=tune_optimizer(config["lr"]), device=device)
    where = {"pid": os.getpid(), "gpu_ids": rt.get_gpu_ids(),
             "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "device_count": torch.cuda.device_count()}
    restored, first = tune.get_checkpoint(), 1
    if restored is None:
        state = init_state(torch.Generator(device=device).manual_seed(0))
    else:
        t0 = time.perf_counter()
        state, times = restore_trial_state(init_state, restored, device)
        first = state["step"] + 1
        t1 = time.perf_counter()
        where.update(restore_s=t1 - t0, **times,
                     restored_from=os.path.basename(restored.path),
                     restored_digest=train_state_digest(state),
                     digest_s=time.perf_counter() - t1)
    tokens = token_batch(cfg.vocab_size, *batch, device=device)
    init_s = time.perf_counter() - entered
    trial_dir = tune.get_trial_dir()
    for step in range(first, TUNE_STEPS + 1):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        state, m = train_step(state, tokens)
        loss = float(m["loss"])  # the fetch ends the step
        row = {"lr": config["lr"], "step": step, "loss": loss,
               "step_s": time.perf_counter() - t0,
               "launches": {name: n - before.get(name, 0)
                            for name, n in _kernels.LAUNCHES.items()},
               **where}
        if step == first:
            row.update(cold_start_s=time.perf_counter() - entered,
                       init_s=init_s, process_age_at_entry_s=age)
            if dashboard:
                row["dashboard"] = read_cluster_status(dashboard)
        checkpoint = None
        if step == TUNE_CHECKPOINT_AT:
            path = tempfile.mkdtemp(prefix="state_", dir=trial_dir)
            t0 = time.perf_counter()
            checkpoint = train.Checkpoint.from_state(state, path)
            row["checkpoint_write_s"] = time.perf_counter() - t0
            row["checkpoint_bytes"] = sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))
            t0 = time.perf_counter()
            row["saved_digest"] = train_state_digest(state)
            row["digest_s"] = time.perf_counter() - t0
        with open(os.path.join(trial_dir, "progress.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        try:
            tune.report({"loss": loss, "training_iteration": step},
                        checkpoint=checkpoint)
        finally:
            if checkpoint is not None:
                shutil.rmtree(path, ignore_errors=True)
        if checkpoint is not None and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("planted failure after the step-4 checkpoint")


def trial_rows(grid) -> list:
    """Every progress row of every trial of a sweep, trial by trial, each
    tagged with its trial."""
    return [dict(row, trial=os.path.basename(result.path))
            for result in grid
            for row in read_rows(os.path.join(result.path,
                                              "progress.jsonl"))]


def sum_launches(rows) -> dict:
    """The kernels' launches summed over rows, each the launches of one
    step (or call) in its own process."""
    total = {}
    for row in rows:
        for name, n in row["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def uninterrupted_losses(cfg, device: str, batch, lr: float,
                         steps: int) -> list:
    """tune_gpt_trial's steps run here without a break: its losses."""
    import torch

    from ray_tpu_torch.models import make_train_step

    init_state, train_step = make_train_step(
        cfg, optimizer=tune_optimizer(lr), device=device)
    state = init_state(torch.Generator(device=device).manual_seed(0))
    tokens = token_batch(cfg.vocab_size, *batch, device=device)
    losses = []
    for _ in range(steps):
        state, m = train_step(state, tokens)
        losses.append(float(m["loss"]))
    return losses


def workflow_k1_step(shape, log_path: str, device: str = "cuda"):
    """Step 1 of the libraries phase's workflow, in a num_gpus=1 task:
    K1 at ``shape`` on this process's card (attention_run), its output
    returned, a CUDA tensor that the store brings to host. Each run
    appends its report (launches, error, card) to ``log_path``."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the workflow's GPU step sees no card")
    out, report = attention_run(shape, True, device)
    with open(log_path, "a") as f:
        f.write(json.dumps(report) + "\n")
    return out


def workflow_check_step(out, marker: str) -> dict:
    """Step 2: fails on its first run (no ``marker`` yet); then step 1's
    output as it arrived, with its device and whether it is finite."""
    import torch

    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("planted failure of the workflow's step 2")
    return {"output": out, "device": str(out.device),
            "finite": bool(torch.isfinite(out).all())}


def read_rows(path: str) -> list:
    """The JSON rows of a JSON-lines file ([] if there is none)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def libraries_checks(m: dict) -> dict:
    """A libraries report against what the phase requires, by name."""
    expected = expected_launches(m["n_layers"], remat=True)
    rows, ref = m["rows"], m["reference_losses"]
    first = [r for r in rows if r["lr"] == TUNE_LRS[0]]
    pids = list(dict.fromkeys(r["pid"] for r in first))
    resumed = [r for r in first if len(pids) == 2 and r["pid"] == pids[1]]
    readings = [r["dashboard"] for r in rows if "dashboard" in r]
    wf, job = m["workflow"], m["job"]
    it = m["iterations"]
    return {
        "no_errors": m["errors"] == [],
        "pinned": bool(rows) and all(
            r["cuda_visible_devices"] == "0" and r["gpu_ids"] == [0]
            and r["device_count"] == 1 for r in rows),
        "asha_cut": it.get(TUNE_LRS[-1], TUNE_STEPS) < TUNE_STEPS
        and m["best_lr"] > 0 and it.get(m["best_lr"]) == TUNE_STEPS,
        "first_loss": bool(first) and first[0]["step"] == 1
        and abs(first[0]["loss"] - m["train_first_loss"])
        <= TOL_TRAIN_DP_LOSS * abs(m["train_first_loss"]),
        "resumed": [r["step"] for r in first] == list(
            range(1, TUNE_STEPS + 1))
        and [r["step"] for r in resumed] == list(
            range(TUNE_CHECKPOINT_AT + 1, TUNE_STEPS + 1))
        and "restored_from" in resumed[0]
        and resumed[0].get("restored_digest") is not None
        and resumed[0]["restored_digest"] == next(
            (r.get("saved_digest") for r in first
             if r["step"] == TUNE_CHECKPOINT_AT), None)
        and all(abs(r["loss"] - ref[r["step"] - 1])
                <= TOL_TUNE_RESUME * abs(ref[r["step"] - 1])
                for r in resumed),
        "launches": bool(rows) and all(r["launches"] == expected
                                       for r in rows),
        "dashboard_during": len(readings) == m["trial_processes"] > 0
        and all(x == {"gpu_total": 1.0, "gpu_available": 0.0, "nodes": 1}
                for x in readings),
        "dashboard_after": m["dashboard_after"] == {
            "gpu_total": 1.0, "gpu_available": 1.0, "nodes": 1},
        "metrics_text": m["metrics_samples"] > 0
        and m["metrics_malformed"] == [],
        "memory_back": m["card_free_after"] is not None
        and m["card_free_after"]
        >= m["card_free_before"] - MULTINODE_MEMORY_SLACK,
        "workflow_resume": wf["statuses"] == ["FAILED", "SUCCESSFUL"]
        and wf["step1_runs"] == [1, 1, 2]
        and set(wf["resume_launches"].values()) == {0}
        and wf["equal_to_uninterrupted"] and wf["output"] == {
            "device": "cpu", "dtype": "torch.bfloat16",
            "shape": list(m["workflow_shape"]), "finite": True},
        "workflow_k1": all(
            r["launches"]["flash_fwd"] == 1 and r["finite"]
            and r["cuda_visible_devices"] == "0"
            and r["max_norm_err"] <= TOL_BF16_NORM
            for r in wf["step1_reports"]),
        "job": job["status"] == "SUCCEEDED" and job["return_code"] == 0
        and job["entrypoint_cuda_available"] in ("True", "False")
        and job["stop"] and job["stopped_status"] == "STOPPED"}


def metrics_format(text: str):
    """(samples, malformed lines) of a Prometheus text exposition."""
    samples = [line for line in text.splitlines()
               if line and not line.startswith("#")]
    bad = [line for line in samples
           if not re.match(r"^[a-zA-Z_:][\w:]*(\{[^}]*\})? \S+$", line)]
    return len(samples), bad


def phase_libraries(train_first_loss: float, cfg=None, device: str = "cuda",
                    batch=(16, 1024), shape=GPT2_SHAPE):
    """The port's libraries on a head that declares the card: a Tune
    sweep of tune_gpt_trial over TUNE_LRS under ASHA with
    FailureConfig(max_failures=1) and the dashboard read during and
    after it; a durable workflow whose num_gpus=1 step 1 runs K1 at
    ``shape`` and whose step 2 fails once, resumed with step 1 read from
    storage, against the same workflow run without a break; a job that
    prints what its entrypoint sees of the card, and one stopped while
    it runs. ``train_first_loss`` is phase_train's first loss on the same
    weights and batch. Returns the trials' and the workflow step's
    launches. (``cfg``, ``device``, ``batch`` and ``shape`` are for the
    CPU tests.)"""
    import shutil
    import tempfile
    import urllib.request

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import dashboard, tune, workflow
    from ray_tpu_torch.job import JobSubmissionClient
    from ray_tpu_torch.models import GPTConfig
    from ray_tpu_torch.ops import _kernels

    cfg = cfg or GPTConfig.gpt2_small()
    reference = uninterrupted_losses(cfg, device, batch, TUNE_LRS[0],
                                     TUNE_STEPS)
    free_before = card_free_bytes(device)
    storage = tempfile.mkdtemp(prefix="rtt_libraries_")
    marker = os.path.join(storage, "trial_failed")
    rt.init(num_cpus=4, num_gpus=1)
    node = current_node()
    try:
        url = f"http://127.0.0.1:{dashboard.start_dashboard()}"
        # The job needs no card: it runs beside the sweep.
        client = JobSubmissionClient()
        job_t0_wall = time.time()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'import torch; "
                       f"print(torch.cuda.is_available())'",
            submission_id="raysubmit_libraries_cuda")
        trainable = tune.with_resources(tune.with_parameters(
            tune_gpt_trial, cfg=cfg, device=device, batch=batch,
            marker=marker, dashboard=url), {"CPU": 1, "GPU": 1})
        tuner = tune.Tuner(
            trainable, param_space={"lr": tune.grid_search(TUNE_LRS)},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1,
                scheduler=tune.ASHAScheduler(
                    max_t=TUNE_STEPS, grace_period=2, reduction_factor=2)),
            run_config=tune.RunConfig(
                name="libraries", storage_path=storage,
                checkpoint_config=tune.CheckpointConfig(num_to_keep=1),
                failure_config=tune.FailureConfig(max_failures=1)))
        reset_launches()
        t0 = time.perf_counter()
        grid = tuner.fit()
        sweep_s = time.perf_counter() - t0
        driver_launches = dict(_kernels.LAUNCHES)
        rows = trial_rows(grid)
        best = grid.get_best_result()
        deadline = time.perf_counter() + 60
        after = read_cluster_status(url)
        while after["gpu_available"] != 1.0 and time.perf_counter() < deadline:
            time.sleep(0.05)
            after = read_cluster_status(url)
        t0 = time.perf_counter()
        free_after = card_free_bytes(device)
        while (free_after is not None
               and free_after < free_before - MULTINODE_MEMORY_SLACK
               and time.perf_counter() < t0 + 60):
            time.sleep(0.2)
            free_after = card_free_bytes(device)
        memory_wait_s = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            samples, malformed = metrics_format(resp.read().decode())

        # The workflow: step 1 on the card, step 2 failing once.
        workflow.init(os.path.join(storage, "workflows"))
        log_path = os.path.join(storage, "k1_runs.jsonl")
        step2_marker = os.path.join(storage, "step2_failed")
        k1 = rt.remote(num_gpus=1)(workflow_k1_step)
        check_step = rt.remote(workflow_check_step)

        def dag():
            return check_step.bind(k1.bind(shape, log_path, device),
                                   step2_marker)

        t0 = time.perf_counter()
        try:
            workflow.run(dag(), workflow_id="k1_durable", max_retries=0)
            failed_first = False
        except Exception:  # noqa: BLE001 — the planted failure
            failed_first = True
        first_run_s = time.perf_counter() - t0
        statuses = [workflow.get_status("k1_durable")]
        runs = [len(read_rows(log_path))]
        reset_launches()
        t0 = time.perf_counter()
        resumed = workflow.resume("k1_durable")
        resume_s = time.perf_counter() - t0
        statuses.append(workflow.get_status("k1_durable"))
        runs.append(len(read_rows(log_path)))
        resume_launches = sum_launches(
            [{"launches": dict(_kernels.LAUNCHES)}]
            + read_rows(log_path)[runs[0]:])
        straight = workflow.run(dag(), workflow_id="k1_straight")
        step1_reports = read_rows(log_path)
        runs.append(len(step1_reports))
        out = resumed["output"]
        wf = {"failed_first_run": failed_first, "statuses": statuses,
              "step1_runs": runs, "step1_reports": step1_reports,
              "resume_launches": resume_launches,
              "first_run_s": first_run_s, "resume_s": resume_s,
              "output": {"device": resumed["device"], "dtype": str(out.dtype),
                         "shape": list(out.shape),
                         "finite": resumed["finite"]},
              "equal_to_uninterrupted": torch.equal(out,
                                                    straight["output"])}

        # The job: what its entrypoint saw of the card, and a stop.
        status = client.wait_until_finish(job_id, timeout=300)
        job_s = client.get_job_info(job_id)["updated_at"] - job_t0_wall
        lines = client.get_job_logs(job_id).split()
        long_id = client.submit_job(entrypoint="sleep 120",
                                    submission_id="raysubmit_libraries_stop")
        deadline = time.perf_counter() + 120
        while (client.get_job_status(long_id) != "RUNNING"
               and time.perf_counter() < deadline):
            time.sleep(0.05)
        stopped = client.stop_job(long_id)
        job = {"status": status,
               "return_code": client.get_job_info(job_id)["return_code"],
               "entrypoint_cuda_available": lines[-1] if lines else None,
               "submit_to_finish_s": job_s, "stop": stopped,
               "stopped_status": client.wait_until_finish(long_id,
                                                          timeout=60)}
    finally:
        dashboard.stop_dashboard()
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    first = [r for r in rows if r["lr"] == TUNE_LRS[0]]
    errs = {r["step"]: abs(r["loss"] - reference[r["step"] - 1])
            / abs(reference[r["step"] - 1]) for r in first}
    m = {"n_layers": cfg.n_layers, "batch": list(batch), "lrs": TUNE_LRS,
         "steps": TUNE_STEPS, "rows": rows, "errors": grid.errors,
         "iterations": {r.config["lr"]: r.metrics.get("training_iteration")
                        for r in grid},
         "best_lr": best.config["lr"],
         "trial_processes": len({r["pid"] for r in rows}),
         "reference_losses": reference, "train_first_loss": train_first_loss,
         "first_loss_rel_err": abs(first[0]["loss"] - train_first_loss)
         / abs(train_first_loss) if first else None,
         "loss_rel_errs_vs_uninterrupted": errs,
         "sweep_s": sweep_s, "driver_launches": driver_launches,
         "dashboard_after": after, "metrics_samples": samples,
         "metrics_malformed": malformed, "card_free_before": free_before,
         "card_free_after": free_after, "memory_wait_s": memory_wait_s,
         "workflow": wf, "workflow_shape": list(shape), "job": job}
    checks = libraries_checks(m)
    checks["no_dirs_left"] = copy_dirs(node) == []
    emit("libraries", **m, trials=trial_summary(rows), checks=checks)
    failed = [name for name, ok in checks.items() if not ok]
    check(not failed, f"libraries checks failed: {failed}")
    return {"tune_trials": sum_launches(rows),
            "workflow_gpu_step": sum_launches(step1_reports)}


def trial_summary(rows) -> list:
    """Per trial process: its lr, steps, cold start, median step ms (its
    first step, which the cold start holds, left out) and its
    checkpoint's write or restore seconds."""
    out = []
    for pid in dict.fromkeys(r["pid"] for r in rows):
        mine = [r for r in rows if r["pid"] == pid]
        first = mine[0]
        out.append({
            "lr": first["lr"], "pid": pid,
            "steps": [r["step"] for r in mine],
            "cold_start_s": first["cold_start_s"],
            "init_s": first["init_s"],
            "process_age_at_entry_s": first["process_age_at_entry_s"],
            "step_ms_median": statistics.median(
                r["step_s"] for r in mine[1:] or mine) * 1e3,
            "checkpoint_write_s": next((r["checkpoint_write_s"] for r in mine
                                        if "checkpoint_write_s" in r), None),
            "checkpoint_bytes": next((r["checkpoint_bytes"] for r in mine
                                      if "checkpoint_bytes" in r), None),
            **{key: first.get(key) for key in (
                "restore_s", "restore_read_s", "restore_init_s")}})
    return out


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
    expected = expected_launches(cfg.n_layers, cfg.remat, qkv=False)
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
    expected = expected_launches(cfg.n_layers, cfg.remat, qkv=False)
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
    expected_classify = expected_launches(cfg.n_layers, cfg.remat, False,
                                          qkv=False)
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

    def recorded(logits, capacity, *rest):
        dispatch, combine, aux = original(logits, capacity, *rest)
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
    flips = route_flip_share(record[:half], record[half:])
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



# The parallel phase: 2 ranks sharing the card, each a process of one gloo
# world (parallel.launch.RankPool(device="cuda"); NCCL takes one rank a
# GPU), GPT-2 small at full width (bf16, remat on).
PAR_RANKS, PAR_STEPS, PAR_BATCH, PAR_SEQ = 2, 3, 8, 1024
PAR_ULYSSES_SHAPE, PAR_RING_SHAPE = (16, 12, 1024, 64), (8, 12, 1024, 64)
PAR_PP_STAGES, PAR_PP_MICRO, PAR_PP_MB = 2, 4, 2
# Deadline of one call to the ranks (a rank stuck in a collective fails
# the phase there).
PAR_TIMEOUT = 300
# tp=2 and fsdp=2 against the tp=1 step from the same weights, bf16.
# The loss, relative: tests/test_torch_train.py holds the bf16 step to
# JAX at 2e-3; here train_dp's 1e-2, since tp rounds each partial product
# to bf16 before the all-reduce sums it (and fsdp each rank's gradient
# before the reduce-scatter). The params after PAR_STEPS steps, per leaf
# |p - ref| over |ref - p0| (2-norms; p0 the start): the share of the
# steps' own move on which the layouts disagree. test_torch_train.py
# holds bf16 params at 2e-2 of each leaf's max |p| at the tiny width; at
# GPT-2's width that measure is dominated by the few elements whose bf16
# gradient is near zero, which AdamW moves by about lr either way
# whatever the gradient's size: 2 lr over 3 steps is 4.9e-2 of wo's and
# w2's max |p| (0.037). It is reported beside, not held.
TOL_PAR_LOSS, TOL_PAR_PARAMS = 1e-2, 0.25
# The first step's gradients, reduced and before AdamW reads them,
# gathered to the JAX layout, against the tp=1 step's, over each leaf's
# max: the bf16 grads band of train_vs_cpu. AdamW's artefact above does
# not reach them, and a gradient off by a factor (summed twice, a dropped
# sum) or in another column order is off by its whole size: the phase
# reads such faults through the same band and requires that each fails.
TOL_PAR_GRADS = VS_CPU_RUNS[1][2]["grads"]
# The pipelines' bf16 grads against the 12 blocks in sequence, over each
# leaf's max: the bf16 grads band of train_vs_cpu (the microbatches'
# weight gradients are summed in bf16, a rounding the whole batch's one
# product does not have).
TOL_PAR_PP_GRADS = VS_CPU_RUNS[1][2]["grads"]
# Expert-parallel moe_layer against the one-device layer on each rank's
# tokens, over each tensor's max: y and the grads of the bf16 tokens and
# experts are bf16, a few ulps of it (2**-8 = 3.9e-3) apart where the
# experts' f32 einsums, run on [E/n, n*C] buffers instead of [E, C], sum
# in another order (the router's f32 grad is held to the same band).
TOL_PAR_MOE = 1e-2
# The Megatron family paths: path -> (family, the split mesh axis, batch,
# sequence; None for ViT's images). Each runs PAR_STEPS timed steps on
# PAR_RANKS ranks against its unsplit step in this process, from the
# seed-0 weights and batch.
PAR_FAMILIES = {
    "llama_tp": ("llama", "tp", 4, 2048),
    "vit_tp": ("vit", "tp", 32, None),
    "moe_tp": ("moe", "tp", 8, 1024),
    "moe_ep": ("moe", "ep", 8, 1024),
}
# Each family path's numbers are held on PAR_F32_STEPS further steps in
# f32, at full width and PAR_F32_LAYERS layers (as train_vs_cpu and
# llama_vs_cpu hold the card to the CPU: the split is the same in every
# layer), against the unsplit step's in f32: the loss (relative) and each
# first-step gradient (over its leaf's max) in train_vs_cpu's f32 bands,
# the params' moves in TOL_PAR_PARAMS (AdamW's artefact above does not
# spare f32: a near-zero gradient's sign still decides a move of lr,
# which is 1.6% of the max of llama's smallest leaves after 2 steps on
# an H100). In bf16, tp's partial products round before the
# all-reduce sums them; on an H100 that moved llama's wq gradients (a
# leaf of its own, small, through 16 layers) by 6% of their max, ViT's
# steeply falling loss by 2% at step 3, and flipped MoE routes, which
# change the tokens capacity drops (MoE's gate gradients 31% apart).
# The bf16 run is timed and counted; its losses and route flips are
# reported beside the unsplit step's.
PAR_F32_STEPS, PAR_F32_LAYERS = 2, 2
TOL_PAR_F32 = VS_CPU_RUNS[0][2]
# The planted faults each family path reads through its gradient band,
# which must reject every one: the gradients doubled; every "f" dropped
# (for ep, take_block's gather of the experts' input gradient); the
# head-aligned column blocks read as contiguous ones; MoE's tp sum moved
# after the combine (the router then sees a share of its gradient), and
# ep's gather with allgather's reduce-scatter backward (the experts'
# gradient counted once a rank).
PAR_FAMILY_CONTROLS = {
    "llama_tp": {"doubled", "f_sums_dropped", "wkv_contiguous_blocks"},
    "vit_tp": {"doubled", "f_sums_dropped", "wqkv_contiguous_blocks"},
    "moe_tp": {"doubled", "f_sums_dropped", "sum_after_combine"},
    "moe_ep": {"doubled", "f_sums_dropped", "gather_summed"},
}


def parallel_expected_launches(path: str, n_layers: int = 12,
                               steps: int = PAR_STEPS) -> dict:
    """K1, K2, K3 launches in each rank's process on a parallel path:
    ``tp``/``fsdp``: ``steps`` GPT steps with remat, every layer's
    attention on each rank (tp on half the heads, fsdp on half the rows);
    a ``PAR_FAMILIES`` path: ``steps`` of its family's step (llama's
    tpu_bench without remat, ViT-B/16's and MoE's with), every layer's
    attention on each rank;
    ``ulysses``: one flash_attention forward and backward on each rank's
    heads; ``gpipe``: each of PAR_PP_MICRO microbatches through the
    rank's n_layers / 2 blocks, forward and backward (no remat); ``1f1b``:
    the same, each stage's forward run twice (in the schedule, then
    recomputed for its backward)."""
    if path in ("tp", "fsdp"):
        return {n: k * steps for n, k in
                expected_launches(n_layers, True).items()}
    if path in PAR_FAMILIES:
        family = PAR_FAMILIES[path][0]
        cfg = family_config(family)
        return {n: k * steps for n, k in expected_launches(
            cfg.n_layers, cfg.remat, qkv=family == "moe").items()}
    if path == "ulysses":
        return {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                "rms_norm_fwd": 0, "rms_norm_bwd": 0, "rms_norm_dw": 0,
                "qkv_rope_fwd": 0, "qkv_rope_bwd": 0}
    # A stage is blocks alone (two norms and one qkv split each, no final
    # norm).
    per_stage = n_layers // PAR_PP_STAGES * PAR_PP_MICRO
    fwd = per_stage * (2 if path == "1f1b" else 1)
    return {"flash_fwd": fwd, "flash_bwd_dq": per_stage,
            "flash_bwd_dkv": per_stage, "rms_norm_fwd": 2 * fwd,
            "rms_norm_bwd": 2 * per_stage, "rms_norm_dw": 2 * per_stage,
            "qkv_rope_fwd": fwd, "qkv_rope_bwd": per_stage}


def tp_all_reduce_bytes(cfg, b: int, s: int, chunk: int = 4096) -> int:
    """Bytes one rank hands to all-reduce in one tensor-parallel GPT step,
    remat on or off: per layer the two "g" sums of the forward (a remat
    recompute takes them back from the forward, as JAX's
    dots_with_no_batch_dims_saveable keeps them) and the two "f" gradient
    sums of the backward, each a [b, s, d] activation in the model dtype;
    the embedding's sum, the final norm's gradient sum, and per loss
    chunk (gpt_loss's: the largest power of two up to ``chunk`` dividing
    the rows) the f32 row max and the stacked [2, chunk] sums."""
    import torch

    act = b * s * cfg.d_model * torch.empty(0, dtype=cfg.dtype).element_size()
    rows = b * s
    while chunk > 1 and rows % chunk:
        chunk //= 2
    return (4 * cfg.n_layers + 2) * act \
        + rows // chunk * 3 * chunk * 4


def fsdp_bytes(params_bytes: int, world: int) -> dict:
    """Bytes one rank hands to each collective in one fsdp step over the
    whole world: its blocks to the all-gather, the whole gradients to the
    reduce-scatter, the f32 loss to the all-reduce."""
    return {"all_gather": params_bytes // world,
            "reduce_scatter": params_bytes, "all_reduce": 4}


def per_step(traffic: dict, steps: int) -> dict:
    """TRAFFIC's snapshot as calls and bytes a step, with transports."""
    return {op: {"calls_per_step": r["calls"] / steps,
                 "bytes_per_step": r["bytes"] / steps,
                 "transports": r["transports"]}
            for op, r in traffic.items()}


def transports(ranks: list) -> dict:
    """op -> the transports any rank used for it, over every path."""
    out: dict = {}
    for rank in ranks:
        for traffic in rank.values():
            for op, r in traffic.items():
                out.setdefault(op, set()).update(r["transports"])
    return {op: sorted(t) for op, t in sorted(out.items())}


def _leaf_errs(ours, ref) -> list:
    """Per leaf, in tree_leaves order: max |ours - ref| / max |ref|, f32."""
    from ray_tpu_torch.models.convert import tree_leaves

    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp_min(1e-30))
            for a, b in zip(tree_leaves(ours), tree_leaves(ref))]


def first_grads_optimizer(store: list):
    """The default optimizer, putting the gradients its first step reads
    (the step's reduced ones, in the params' order) into ``store``."""
    from ray_tpu_torch.models._training import default_optimizer

    def make(params):
        opt = default_optimizer(params)

        def keep(_opt, _args, _kwargs):
            if not store:
                store.extend(p.grad.detach().clone() for p in params)
        opt.register_step_pre_hook(keep)
        return opt
    return make


def contiguous_wqkv(w, n: int, segments: int = 3):
    """A JAX-layout wqkv ([d, 3d], columns [q | k | v]; llama's wkv with
    ``segments=2``, [k | v]) with its columns in the order of n
    head-aligned blocks put side by side: rank r's [q_r | k_r | v_r],
    then rank r + 1's. A gather that concatenated the tp blocks would
    give this."""
    import torch

    width = w.shape[-1] // segments
    parts = [x.chunk(n, dim=-1) for x in w.split(width, dim=-1)]
    return torch.cat([p[r] for r in range(n) for p in parts], dim=-1)


def par_reference(path: str, b: int, s: int, steps: int) -> dict:
    """The tp=1 GPT-2-small step in this process on the card, from the
    seed-0 weights: losses, step seconds, and the params and the first
    step's gradients saved to ``path`` (CPU tensors) for the ranks to
    compare with."""
    import torch

    from ray_tpu_torch._tree import tree_map, tree_unflatten
    from ray_tpu_torch.models import GPTConfig, make_train_step

    cfg = GPTConfig.gpt2_small()
    grads: list = []
    init_state, train_step = make_train_step(
        cfg, optimizer=first_grads_optimizer(grads))
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    batch = token_batch(cfg.vocab_size, b, s)
    losses, steps_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
        steps_s.append(time.perf_counter() - t0)
    def to_cpu(tree):
        return tree_map(lambda t, _: t.detach().cpu(), tree)
    torch.save({"params": to_cpu(state["params"]),
                "grads": to_cpu(tree_unflatten(state["params"], grads))},
               path)
    del state, grads
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": [t * 1e3 for t in steps_s]}


def par_train_rank(kind: str, ref_path: str, b: int, s: int,
                   steps: int) -> dict:
    """One rank of the tp=2 or fsdp=2 GPT-2-small step: ``steps`` steps
    from the seed-0 weights on this rank's part of the seed-0 batch, the
    launches and collectives counted over exactly them; then the params
    and the first step's gradients gathered to the JAX layout, compared
    on rank 0 with the tp=1 step's. The gradients' controls, which the
    band must reject: them doubled, tp's wqkv in a contiguous-block
    order, and (tp) one step from the same weights with every "f"
    gradient sum dropped."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch._tree import tree_leaves, tree_unflatten
    from ray_tpu_torch.models import GPTConfig, make_train_step, shard_batch
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.gpt import gather_gpt_params
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import (MeshConfig, fsdp_rules, make_mesh,
                                        ops, tp_rules)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()
    world = dist.get_world_size()
    mesh = make_mesh(MeshConfig(dp=1, **{kind: world}), device_type="cuda")
    rules = tp_rules() if kind == "tp" else fsdp_rules()
    grads: list = []
    init_state, train_step = make_train_step(
        cfg, optimizer=first_grads_optimizer(grads), mesh=mesh, rules=rules)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    batch = shard_batch(token_batch(cfg.vocab_size, b, s), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ops.TRAFFIC.reset()
    losses, steps_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))  # the fetch ends the step
        steps_s.append(time.perf_counter() - t0)
    launches = dict(_kernels.LAUNCHES)
    traffic = ops.TRAFFIC.snapshot()
    leaves = tree_leaves(state["params"])
    opt = state["opt_state"]
    row = {"pid": os.getpid(), "rank": dist.get_rank(),
           "launches": launches, "traffic": traffic, "losses": losses,
           "step_ms": [t * 1e3 for t in steps_s],
           "block_bytes": sum(p.numel() * p.element_size() for p in leaves),
           "moments_sharded": all(
               opt.state[p]["exp_avg"].shape == p.shape for p in leaves),
           "wqkv_block": list(state["params"]["layers"][0]["wqkv"].shape),
           "w1_block": list(state["params"]["layers"][0]["w1"].shape),
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    full = gather_gpt_params(state["params"], cfg, mesh, rules)
    full_grads = gather_gpt_params(tree_unflatten(state["params"], grads),
                                   cfg, mesh, rules)
    row["params_bytes"] = sum(p.numel() * p.element_size()
                              for p in tree_leaves(full))
    dropped = None
    if kind == "tp":
        del state, grads
        control: list = []
        init_c, step_c = make_train_step(
            cfg, optimizer=first_grads_optimizer(control), mesh=mesh,
            rules=rules)
        state = init_c(torch.Generator(device="cuda").manual_seed(0))
        kept = gpt.grad_allreduce
        gpt.grad_allreduce = lambda x, axis_name: x
        try:
            step_c(state, batch)
        finally:
            gpt.grad_allreduce = kept
        dropped = gather_gpt_params(tree_unflatten(state["params"], control),
                                    cfg, mesh, rules)
    if dist.get_rank() == 0:
        from ray_tpu_torch.models import gpt_init

        saved = torch.load(ref_path, map_location="cuda")
        ref, ref_grads = saved["params"], saved["grads"]
        start = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
        row["param_errs"] = _leaf_errs(full, ref)
        row["param_move_errs"] = [
            float((a.float() - b.float()).norm()
                  / (b.float() - c.float()).norm().clamp_min(1e-30))
            for a, b, c in zip(tree_leaves(full), tree_leaves(ref),
                               tree_leaves(start))]
        row["grad_errs"] = _leaf_errs(full_grads, ref_grads)
        controls = {"doubled": max(_leaf_errs(
            [2 * g for g in tree_leaves(full_grads)], ref_grads))}
        if kind == "tp":
            controls["wqkv_contiguous_blocks"] = max(_leaf_errs(
                [contiguous_wqkv(lay["wqkv"], world)
                 for lay in full_grads["layers"]],
                [lay["wqkv"] for lay in ref_grads["layers"]]))
            controls["f_sums_dropped"] = max(_leaf_errs(dropped, ref_grads))
        row["grad_control_errs"] = controls
    return row


def par_ulysses_rank(shape) -> dict:
    """Ulysses sp=2 with attn_fn=flash_attention on the seeded bf16 q, k,
    v: forward and backward of sum(out * w), launches and collectives
    counted over exactly it; then flash_attention on the whole tensors on
    this rank, against which out and the grads are compared."""
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import make_1d_mesh, ops
    from ray_tpu_torch.parallel.partition import PartitionSpec as P
    from ray_tpu_torch.parallel.sequence import ulysses_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, w = (torch.randn(shape, generator=g, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    mesh = make_1d_mesh("sp", device_type="cuda")
    spec = P(None, None, "sp", None)
    fn = ops.shard_map(
        lambda a, b, c: ulysses_attention(a, b, c, "sp",
                                          attn_fn=flash_attention),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)

    def run(attn):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = attn(*xs)
        (out.float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), [x.grad for x in xs], time.perf_counter() - t0

    run(fn)  # warm-up
    reset_launches()
    ops.TRAFFIC.reset()
    out, grads, secs = run(fn)
    launches = dict(_kernels.LAUNCHES)
    traffic = ops.TRAFFIC.snapshot()
    run(lambda a, b, c: flash_attention(a, b, c, True))  # warm-up
    ref, ref_grads, ref_secs = run(
        lambda a, b, c: flash_attention(a, b, c, True))
    return {"pid": os.getpid(), "launches": launches, "traffic": traffic,
            "ms": secs * 1e3, "one_device_ms": ref_secs * 1e3,
            "out_err": _norm_err(out, ref),
            "grad_errs": [_norm_err(a, b) for a, b in zip(grads, ref_grads)],
            "bit_identical": bool(torch.equal(out, ref)) and all(
                torch.equal(a, b) for a, b in zip(grads, ref_grads))}


def par_ring_rank(shape) -> dict:
    """Ring attention sp=2 (sequence_parallel_attention, forward) on the
    seeded bf16 q, k, v, against mha_reference on the whole tensors."""
    import torch

    from ray_tpu_torch.ops.attention import mha_reference
    from ray_tpu_torch.parallel import make_1d_mesh, ops
    from ray_tpu_torch.parallel.sequence import sequence_parallel_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(22)
    q, k, v = (torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    mesh = make_1d_mesh("sp", device_type="cuda")
    with torch.no_grad():
        sequence_parallel_attention(mesh, q, k, v)  # warm-up
        ops.TRAFFIC.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sequence_parallel_attention(mesh, q, k, v)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        traffic = ops.TRAFFIC.snapshot()
        t0 = time.perf_counter()
        ref = mha_reference(q, k, v, True)
        torch.cuda.synchronize()
        ref_secs = time.perf_counter() - t0
    return {"traffic": traffic, "ms": secs * 1e3,
            "one_device_ms": ref_secs * 1e3, "out_err": _norm_err(out, ref)}


def par_moe_rank() -> dict:
    """moe_layer(axis_name="ep") at MoEConfig()'s width (8192 tokens, d
    512, 8 experts, 4 a rank, bf16 tokens and experts, f32 router) under
    shard_map, forward and backward of sum(y * w) + aux; against the
    one-device moe_layer on each rank's tokens in turn (the same
    per-shard capacity), the grads summed over the shards."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import MoEConfig
    from ray_tpu_torch.parallel import make_1d_mesh, ops
    from ray_tpu_torch.parallel.moe import moe_layer
    from ray_tpu_torch.parallel.partition import PartitionSpec as P

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MoEConfig()
    t, d, e, f = MOE_SHAPE[0] * MOE_SHAPE[2], cfg.d_model, cfg.n_experts, \
        cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(23)

    def draw(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    x = draw((t, d), 1.0, torch.bfloat16)
    gate = draw((d, e), d ** -0.5, torch.float32)
    w1 = draw((e, d, f), d ** -0.5, torch.bfloat16)
    w2 = draw((e, f, d), d ** -0.5, torch.bfloat16)
    w = draw((t, d), 1.0, torch.float32)
    n = dist.get_world_size()
    mesh = make_1d_mesh("ep", device_type="cuda")
    fn = ops.shard_map(
        lambda a, b, c, dd: moe_layer(a, b, c, dd, cfg.capacity_factor,
                                      axis_name="ep"),
        mesh=mesh, in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=(P("ep"), P()))

    def run(layer):
        xs = [p.clone().requires_grad_(True) for p in (x, gate, w1, w2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = layer(*xs)
        ((y.float() * w).sum() + aux).backward()
        torch.cuda.synchronize()
        return y.detach(), float(aux.detach()), [p.grad for p in xs], \
            time.perf_counter() - t0

    def one_device(a, b, c, dd):
        parts = [moe_layer(part, b, c, dd, cfg.capacity_factor)
                 for part in a.chunk(n)]
        return (torch.cat([y for y, _ in parts]),
                torch.stack([aux for _, aux in parts]).mean())

    run(fn)  # warm-up
    ops.TRAFFIC.reset()
    y, aux, grads, secs = run(fn)
    traffic = ops.TRAFFIC.snapshot()
    run(one_device)
    ref, ref_aux, ref_grads, ref_secs = run(one_device)
    return {"traffic": traffic, "ms": secs * 1e3,
            "one_device_ms": ref_secs * 1e3, "tokens": t,
            "y_err": _norm_err(y, ref), "aux": aux, "ref_aux": ref_aux,
            "grad_errs": [_norm_err(a, b) for a, b in zip(grads,
                                                          ref_grads)]}


def par_pp_rank(kind: str) -> dict:
    """GPipe (``kind="gpipe"``) or 1F1B training of GPT-2 small's 12
    blocks as PAR_PP_STAGES stages over ``pp``, PAR_PP_MICRO microbatches
    of PAR_PP_MB x PAR_SEQ (seeded bf16 activations, f32 targets, mean
    squared error), launches and collectives counted over exactly the
    step; then the 12 blocks in sequence on this rank, whose grads the
    pipeline's are compared with."""
    import torch

    from ray_tpu_torch.models import GPTConfig, gpt_init
    from ray_tpu_torch.models.convert import tree_leaves
    from ray_tpu_torch.models.gpt import _block
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import make_1d_mesh, ops
    from ray_tpu_torch.parallel.pipeline import (make_1f1b_train_fn,
                                                 make_pipelined_train_fn)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(GPTConfig.gpt2_small(), remat=False)
    layers = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")["layers"]
    per = cfg.n_layers // PAR_PP_STAGES
    stacked = {"layers": [
        {key: torch.stack([layers[s * per + j][key]
                           for s in range(PAR_PP_STAGES)])
         for key in layers[0]} for j in range(per)]}
    g = torch.Generator(device="cuda").manual_seed(24)
    rows = PAR_PP_MICRO * PAR_PP_MB
    x = torch.randn((rows, PAR_SEQ, cfg.d_model), generator=g,
                    device="cuda").to(cfg.dtype)
    y = torch.randn((rows, PAR_SEQ, cfg.d_model), generator=g,
                    device="cuda")

    def stage(params, a):
        for layer in params["layers"]:
            a = _block(a, layer, cfg)
        return a

    def loss_fn(out, target):
        return ((out.float() - target) ** 2).mean()

    mesh = make_1d_mesh("pp", device_type="cuda")
    make = make_1f1b_train_fn if kind == "1f1b" else make_pipelined_train_fn
    step = make(mesh, stage, loss_fn, PAR_PP_MICRO)
    step(stacked, x, y)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    ops.TRAFFIC.reset()
    t0 = time.perf_counter()
    loss, grads = step(stacked, x, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    traffic = ops.TRAFFIC.snapshot()

    def sequential():
        seq = [{k: v.detach().requires_grad_(True) for k, v in lay.items()}
               for lay in layers]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = x
        for lay in seq:
            a = _block(a, lay, cfg)
        ref_loss = loss_fn(a, y)
        ref_loss.backward()
        torch.cuda.synchronize()
        return seq, float(ref_loss), time.perf_counter() - t0

    sequential()  # warm-up
    seq, ref_loss, ref_secs = sequential()
    ref = {"layers": [
        {key: torch.stack([seq[s * per + j][key].grad
                           for s in range(PAR_PP_STAGES)])
         for key in layers[0]} for j in range(per)]}
    return {"pid": os.getpid(), "launches": launches, "traffic": traffic,
            "ms": secs * 1e3, "one_device_ms": ref_secs * 1e3,
            "loss": float(loss), "ref_loss": ref_loss,
            "grad_errs": _leaf_errs(grads, ref),
            "leaves": len(tree_leaves(grads))}


def family_config(family: str, **overrides):
    """The full-width config of a family's parallel path, bf16: llama's
    tpu_bench (remat off), ViT-B/16 and MoEConfig() (remat on)."""
    from ray_tpu_torch.models import LlamaConfig, MoEConfig, ViTConfig

    cfg = {"llama": LlamaConfig.tpu_bench, "vit": ViTConfig.vit_b16,
           "moe": MoEConfig}[family]()
    return dataclasses.replace(cfg, **overrides)


def family_api(family: str):
    """(make_*_train_step, *_param_axes, *_init, the model module) of a
    family; the module's TP_SEGMENTS lays out its head-aligned blocks."""
    from ray_tpu_torch.models import llama, moe, vit

    return {"llama": (llama.make_llama_train_step, llama.llama_param_axes,
                      llama.llama_init, llama),
            "vit": (vit.make_vit_train_step, vit.vit_param_axes,
                    vit.vit_init, vit),
            "moe": (moe.make_moe_train_step, moe.moe_param_axes,
                    moe.moe_init, moe)}[family]


def family_batch(family: str, cfg, b: int, s, device: str = "cuda"):
    """The seed-0 batch of a family's path: tokens and their next tokens,
    or ViT's images (standard normal) and labels."""
    import numpy as np
    import torch

    if family != "vit":
        return token_batch(cfg.vocab_size, b, s, device=device)
    rng = np.random.default_rng(0)
    images = rng.standard_normal(
        (b, cfg.image_size, cfg.image_size, cfg.channels)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, b, dtype=np.int64)
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))


def family_bytes(path: str, cfg, b: int, s, n: int = PAR_RANKS) -> dict:
    """Bytes one rank hands each collective in one step of a family path
    on n ranks, by op (no other op runs). tp: the "g" sums of the forward
    (llama's and MoE's whole-block remat recompute the attention's again;
    GPT's and ViT's keep them, tp_all_reduce_bytes) and the "f" gradient
    sums of the backward. llama: GPT's reckoning (its unchunked loss
    moves the same f32 sums). ViT: 4 [b, 197, d] sums a layer, remat on
    or off, and the row-parallel patch projection's [b, 196, d] sum; no
    loss sums (the class head is replicated). MoE tp: attention's
    2 (3) [b, s, d] sums a layer and 2 (3) of the experts' f32 [E, C, d]
    buffers (the outputs' sum, the inputs' "f"), the embedding's and the
    final "f"'s [b, s, d] and the loss's f32 sums. MoE ep: 2 (3) f32
    all-gathers a layer of a rank's E / n experts' [C, d] buffers (the
    outputs forward, the inputs' gradient backward)."""
    import torch

    family, axis = PAR_FAMILIES[path][:2]
    elt = torch.empty(0, dtype=cfg.dtype).element_size()
    again = 1 if cfg.remat else 0
    if family == "llama":
        return {"all_reduce": tp_all_reduce_bytes(cfg, b, s) + again
                * cfg.n_layers * b * s * cfg.d_model * elt}
    if family == "vit":
        seq = cfg.num_patches + 1
        return {"all_reduce": 4 * cfg.n_layers * b * seq
                * cfg.d_model * elt + b * cfg.num_patches * cfg.d_model * elt}
    tokens = b * s
    capacity = max(1, int(cfg.capacity_factor * tokens * 2 / cfg.n_experts))
    experts = cfg.n_experts * capacity * cfg.d_model * 4
    if axis == "ep":
        return {"all_gather": (2 + again) * cfg.n_layers * experts // n}
    act = tokens * cfg.d_model * elt
    return {"all_reduce": (2 + again) * cfg.n_layers * (act + experts)
            + 2 * act + 3 * tokens * 4}


def family_blocks(path: str, cfg, n: int = PAR_RANKS) -> dict:
    """A rank's block shapes of the params a family path splits (and of
    one it keeps whole) on n ranks: Megatron's columns and rows."""
    family, axis = PAR_FAMILIES[path][:2]
    d, f = cfg.d_model, cfg.d_ff
    if family == "llama":
        kv = 2 * cfg.n_kv_heads * cfg.head_dim
        return {"wq": [d, d // n], "wkv": [d, kv // n], "wo": [d // n, d],
                "w_gate": [d, f // n], "w_down": [f // n, d],
                "embed": [cfg.vocab_size // n, d],
                "head": [d, cfg.vocab_size // n]}
    if family == "vit":
        return {"wqkv": [d, 3 * d // n], "wo": [d // n, d],
                "w1": [d, f // n], "w2": [f // n, d],
                "patch": [cfg.patch_dim // n, d],
                "head": [d, cfg.num_classes]}
    t, x = (n, 1) if axis == "tp" else (1, n)
    e = cfg.n_experts
    return {"wqkv": [d, 3 * d // t], "wo": [d // t, d], "gate": [d, e],
            "expert_w1": [e // x, d, f // t],
            "expert_w2": [e // x, f // t, d],
            "embed": [cfg.vocab_size // t, d]}


@contextlib.contextmanager
def planted_fault(family: str, fault: str):
    """A planted fault in a family step's collectives while the block
    runs (module attributes swapped, put back after): ``f_sums_dropped``
    every "f" an identity both ways (ep: take_block's gradient not
    gathered); ``sum_after_combine`` MoE's tp sum of the experts' outputs
    after the combine; ``f_on_gate`` an "f" on MoE's router input too;
    ``gather_summed`` ep's gather with allgather's reduce-scatter
    backward."""
    import torch

    from ray_tpu_torch.parallel import moe as pmoe
    from ray_tpu_torch.parallel import ops

    module = family_api(family)[3]
    swaps = []
    if fault == "f_sums_dropped":
        def narrow(x, axis_name, axis=0):
            width = x.shape[axis] // ops.axis_size(axis_name)
            return x.narrow(axis, ops.axis_index(axis_name) * width, width)
        swaps = [(module, "grad_allreduce", lambda x, axis_name: x),
                 (ops, "grad_allreduce", lambda x, axis_name: x),
                 (ops, "take_block", narrow)]
    elif fault == "sum_after_combine":
        def after(ye, combine, tp, ep):
            if ep is not None:
                ye = ops.allgather_invariant(ye, ep, 0)
            y = torch.einsum("ecd,tec->td", ye, combine)
            return ops.allreduce(y, tp) if tp is not None else y
        swaps = [(pmoe, "_combine", after)]
    elif fault == "f_on_gate":
        def logits(x, gate_w):
            return ops.grad_allreduce(x, "tp").float() @ gate_w.float()
        swaps = [(pmoe, "_router_logits", logits)]
    elif fault == "gather_summed":
        swaps = [(ops, "allgather_invariant",
                  lambda x, axis_name, axis=0: ops.allgather(x, axis_name,
                                                             axis=axis))]
    else:
        raise ValueError(f"unknown fault {fault!r}")
    kept = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, value in swaps:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in kept:
            setattr(obj, name, value)


def _family_run(family: str, cfg, data, steps: int, device: str, mesh=None,
                rules=None, fault=None) -> dict:
    """``steps`` steps of a family's step from the seed-0 weights (on a
    mesh: this rank's part), each ended by fetching the loss: the state,
    the losses, step seconds, the first step's gradients (as the
    optimizer read them) and, for MoE, each layer's kept routes of the
    first step's forward. ``fault`` plants a ``planted_fault`` for the
    run."""
    import torch

    from ray_tpu_torch.parallel import moe as pmoe

    make = family_api(family)[0]
    grads: list = []
    init_state, train_step = make(cfg, optimizer=first_grads_optimizer(grads),
                                  device=device, mesh=mesh, rules=rules)
    state = init_state(torch.Generator(device=device).manual_seed(0))
    planted = planted_fault(family, fault) if fault \
        else contextlib.nullcontext()
    routes: list = []
    losses, steps_s = [], []
    with planted:
        for i in range(steps):
            kept = record_routes(routes) if family == "moe" and i == 0 \
                else None
            t0 = time.perf_counter()
            try:
                state, m = train_step(state, data)
                losses.append(float(m["loss"]))  # the fetch ends the step
            finally:
                if kept is not None:
                    pmoe.top2_gating = kept
            steps_s.append(time.perf_counter() - t0)
    return {"state": state, "losses": losses, "steps_s": steps_s,
            "grads": grads,
            # the forward's calls come first; the remat recompute's after
            "routes": routes[:cfg.n_layers]}


def held_config(cfg):
    """The config of a family path's held f32 steps: ``cfg`` in f32 with
    PAR_F32_LAYERS layers."""
    import torch

    return dataclasses.replace(cfg, dtype=torch.float32,
                               n_layers=min(cfg.n_layers, PAR_F32_LAYERS))


def route_flip_share(routes, ref) -> float:
    """The share of tokens (over every layer) whose kept experts differ
    between two runs' recorded routes."""
    import torch

    if not ref:
        return 0.0
    a, b = (torch.stack([r.cpu() for r in x]) for x in (routes, ref))
    return float((a != b).any(-1).float().mean())


def par_family_reference(path: str, ref_path: str, overrides=None,
                         batch=None, device: str = "cuda") -> dict:
    """A family path's unsplit step in this process, from the seed-0
    weights and batch: PAR_STEPS timed steps in the model dtype (losses,
    step ms, peak memory), then PAR_F32_STEPS steps of ``held_config``;
    what the ranks compare with (the losses and MoE's routes of both
    runs, the f32 params and first gradients) saved to ``ref_path`` (CPU
    tensors). (``overrides``, ``batch`` and ``device`` are for the CPU
    tests.)"""
    import torch

    from ray_tpu_torch._tree import tree_map, tree_unflatten

    family, _, b, s = PAR_FAMILIES[path]
    b, s = batch or (b, s)
    cfg = family_config(family, **(overrides or {}))
    data = family_batch(family, cfg, b, s, device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    timed = _family_run(family, cfg, data, PAR_STEPS, device)
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if device == "cuda" else None
    del timed["state"]
    held = _family_run(family, held_config(cfg), data, PAR_F32_STEPS,
                       device)

    def to_cpu(tree):
        return tree_map(lambda t, _: t.detach().cpu(), tree)
    params = held["state"]["params"]
    torch.save({"losses": timed["losses"], "routes": timed["routes"],
                "f32_losses": held["losses"], "f32_routes": held["routes"],
                "f32_params": to_cpu(params),
                "f32_grads": to_cpu(tree_unflatten(params, held["grads"]))},
               ref_path)
    del held, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"losses": timed["losses"],
            "step_ms": [t * 1e3 for t in timed["steps_s"]],
            "max_memory_allocated_gb": peak}


def par_family_rank(path: str, ref_path: str, overrides=None, batch=None,
                    device: str = "cuda") -> dict:
    """One rank of a family path (PAR_FAMILIES), split over its axis from
    the seed-0 weights and batch. PAR_STEPS timed steps in the model
    dtype: launches and collectives counted over exactly them, step ms,
    peak memory, this rank's blocks, the losses (and MoE's routes) beside
    the unsplit step's. Then PAR_F32_STEPS steps of ``held_config`` (f32,
    PAR_F32_LAYERS layers), whose params and first gradients, gathered
    to the JAX layout, rank 0 holds to the unsplit f32 step's, with each
    control of PAR_FAMILY_CONTROLS read through the same measure (the
    stepped ones one f32 step each from the same weights under
    ``planted_fault``). bf16's rounding of the partial sums moves a deep
    stack's small gradients and MoE's routes too far for an elementwise
    band; f32's does not."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch._tree import tree_leaves, tree_unflatten
    from ray_tpu_torch.models import shard_batch
    from ray_tpu_torch.models._training import gather_params
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, ops, tp_rules

    family, axis, b, s = PAR_FAMILIES[path]
    b, s = batch or (b, s)
    cfg = family_config(family, **(overrides or {}))
    _, axes_of, init, module = family_api(family)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    world = dist.get_world_size()
    mesh = make_mesh(MeshConfig(dp=1, **{axis: world}), device_type=device)
    rules = tp_rules()
    data = shard_batch(family_batch(family, cfg, b, s, device), mesh)
    f32 = held_config(cfg)

    def whole(run, leaves=None):
        params = run["state"]["params"]
        tree = params if leaves is None else tree_unflatten(params, leaves)
        return gather_params(tree, axes_of(cfg), mesh, rules,
                             module.TP_SEGMENTS)

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ops.TRAFFIC.reset()
    timed = _family_run(family, cfg, data, PAR_STEPS, device, mesh, rules)
    launches = dict(_kernels.LAUNCHES)
    traffic = ops.TRAFFIC.snapshot()
    params = timed["state"]["params"]
    named = {**params["layers"][0],
             **{k: v for k, v in params.items() if k != "layers"}}
    row = {"pid": os.getpid(), "rank": dist.get_rank(),
           "launches": launches, "traffic": traffic,
           "losses": timed["losses"],
           "step_ms": [t * 1e3 for t in timed["steps_s"]],
           "blocks": {k: list(named[k].shape)
                      for k in family_blocks(path, cfg, world)},
           "block_bytes": sum(p.numel() * p.element_size()
                              for p in tree_leaves(params)),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
           / 1e9 if device == "cuda" else None}
    routes = timed["routes"]
    del timed, params, named
    held = _family_run(family, f32, data, PAR_F32_STEPS, device, mesh,
                       rules)
    row["f32_losses"] = held["losses"]
    full, full_grads = whole(held), whole(held, held["grads"])
    row["params_bytes"] = sum(p.numel() * p.element_size()
                              for p in tree_leaves(full))
    f32_routes = held["routes"]
    del held
    stepped = {}
    for fault in sorted(PAR_FAMILY_CONTROLS[path] - {
            "doubled", "wkv_contiguous_blocks", "wqkv_contiguous_blocks"}):
        run = _family_run(family, f32, data, 1, device, mesh, rules, fault)
        stepped[fault] = whole(run, run["grads"])
        del run
    if dist.get_rank() == 0:
        saved = torch.load(ref_path, map_location=device)
        ref, ref_grads = saved["f32_params"], saved["f32_grads"]
        row["ref_losses"] = saved["losses"]
        row["ref_f32_losses"] = saved["f32_losses"]
        if family == "moe":
            row["route_flip_share"] = route_flip_share(routes,
                                                       saved["routes"])
            row["f32_route_flip_share"] = route_flip_share(
                f32_routes, saved["f32_routes"])
        start = init(f32, torch.Generator(device=device).manual_seed(0),
                     device)
        row["param_errs"] = _leaf_errs(full, ref)
        row["param_move_errs"] = [
            float((a.float() - b.float()).norm()
                  / (b.float() - c.float()).norm().clamp_min(1e-30))
            for a, b, c in zip(tree_leaves(full), tree_leaves(ref),
                               tree_leaves(start))]
        row["grad_errs"] = _leaf_errs(full_grads, ref_grads)
        controls = {"doubled": max(_leaf_errs(
            [2 * g for g in tree_leaves(full_grads)], ref_grads))}
        for key, parts in (("wkv", 2), ("wqkv", 3)):
            if f"{key}_contiguous_blocks" in PAR_FAMILY_CONTROLS[path]:
                controls[f"{key}_contiguous_blocks"] = max(_leaf_errs(
                    [contiguous_wqkv(lay[key], world, parts)
                     for lay in full_grads["layers"]],
                    [lay[key] for lay in ref_grads["layers"]]))
        for fault, got in stepped.items():
            controls[fault] = max(_leaf_errs(got, ref_grads))
        row["grad_control_errs"] = controls
    return row


def parallel_checks(rows: dict, ref_losses: list, driver_pid: int
                    ) -> dict:
    """Every check of the parallel phase by name, from its rows."""
    from ray_tpu_torch.models import GPTConfig

    checks = {}
    for kind in ("tp", "fsdp"):
        ranks = rows[kind]
        want = parallel_expected_launches(kind)
        errs = [abs(a - b) / abs(b)
                for a, b in zip(ranks[0]["losses"], ref_losses)]
        checks[f"{kind}_launches"] = all(r["launches"] == want
                                         for r in ranks)
        checks[f"{kind}_other_processes"] = len(
            {r["pid"] for r in ranks} | {driver_pid}) == len(ranks) + 1
        checks[f"{kind}_ranks_agree"] = all(
            r["losses"] == ranks[0]["losses"] for r in ranks)
        checks[f"{kind}_losses"] = len(errs) == PAR_STEPS and all(
            math.isfinite(x) for x in ranks[0]["losses"]) \
            and max(errs) <= TOL_PAR_LOSS
        checks[f"{kind}_params"] = max(ranks[0]["param_move_errs"]) \
            <= TOL_PAR_PARAMS
        checks[f"{kind}_grads"] = max(ranks[0]["grad_errs"]) \
            <= TOL_PAR_GRADS
        controls = ranks[0]["grad_control_errs"]
        checks[f"{kind}_grad_controls_rejected"] = set(controls) == (
            {"doubled", "wqkv_contiguous_blocks", "f_sums_dropped"}
            if kind == "tp" else {"doubled"}) and all(
            err > TOL_PAR_GRADS for err in controls.values())
        checks[f"{kind}_moments_sharded"] = all(r["moments_sharded"]
                                                for r in ranks)
    checks["tp_bytes"] = all(
        r["traffic"]["all_reduce"]["bytes"] == PAR_STEPS
        * tp_all_reduce_bytes(GPTConfig.gpt2_small(), PAR_BATCH, PAR_SEQ)
        for r in rows["tp"])
    fsdp = rows["fsdp"][0]
    want = fsdp_bytes(fsdp["params_bytes"], PAR_RANKS)
    checks["fsdp_bytes"] = all(
        {op: r["traffic"][op]["bytes"] for op in want}
        == {op: n * PAR_STEPS for op, n in want.items()}
        for r in rows["fsdp"])
    uly = rows["ulysses"]
    checks["ulysses_launches"] = all(
        r["launches"] == parallel_expected_launches("ulysses") for r in uly)
    checks["ulysses_out"] = all(r["out_err"] <= TOL_BF16_NORM for r in uly)
    checks["ulysses_grads"] = all(max(r["grad_errs"]) <= TOL_BWD_BF16_NORM
                                  for r in uly)
    checks["ring_out"] = all(r["out_err"] <= TOL_BF16_NORM
                             for r in rows["ring"])
    moe = rows["moe"]
    checks["moe_y"] = all(r["y_err"] <= TOL_PAR_MOE for r in moe)
    checks["moe_aux"] = all(abs(r["aux"] - r["ref_aux"])
                            <= 1e-5 * abs(r["ref_aux"]) for r in moe)
    checks["moe_grads"] = all(max(r["grad_errs"]) <= TOL_PAR_MOE
                              for r in moe)
    for kind in ("gpipe", "1f1b"):
        ranks = rows[kind]
        checks[f"{kind}_launches"] = all(
            r["launches"] == parallel_expected_launches(kind)
            for r in ranks)
        checks[f"{kind}_grads"] = all(
            max(r["grad_errs"]) <= TOL_PAR_PP_GRADS for r in ranks)
        checks[f"{kind}_loss"] = all(
            abs(r["loss"] - r["ref_loss"]) <= TOL_PAR_LOSS * r["ref_loss"]
            for r in ranks)
    for path, (family, _, b, s) in PAR_FAMILIES.items():
        checks.update(family_checks(path, rows[path], driver_pid,
                                    family_config(family), b, s))
    return checks


def family_checks(path: str, ranks: list, driver_pid: int, cfg, b: int, s
                  ) -> dict:
    """The checks of one family path, by name, from its ranks' rows (rank
    0's carries the unsplit step's losses and the f32 comparisons)."""
    r0 = ranks[0]
    tol = TOL_PAR_F32
    errs = [abs(a - b) / abs(b) for a, b in zip(r0["f32_losses"],
                                                r0["ref_f32_losses"])]
    want = {op: n * PAR_STEPS
            for op, n in family_bytes(path, cfg, b, s, len(ranks)).items()}
    controls = r0["grad_control_errs"]
    checks = {
        f"{path}_launches": all(r["launches"]
                                == parallel_expected_launches(path)
                                for r in ranks),
        f"{path}_other_processes": len({r["pid"] for r in ranks}
                                       | {driver_pid}) == len(ranks) + 1,
        f"{path}_ranks_agree": all(
            r["losses"] == r0["losses"]
            and r["f32_losses"] == r0["f32_losses"] for r in ranks),
        f"{path}_losses": len(r0["losses"]) == PAR_STEPS
        and len(errs) == PAR_F32_STEPS
        and all(math.isfinite(x) for x in r0["losses"])
        and max(errs) <= tol["loss"],
        f"{path}_params": max(r0["param_move_errs"]) <= TOL_PAR_PARAMS,
        f"{path}_grads": max(r0["grad_errs"]) <= tol["grads"],
        f"{path}_grad_controls_rejected": set(controls)
        == PAR_FAMILY_CONTROLS[path]
        and all(err > tol["grads"] for err in controls.values()),
        f"{path}_bytes": all({op: r["bytes"] for op, r in
                              rank["traffic"].items()} == want
                             for rank in ranks),
        f"{path}_blocks": all(r["blocks"]
                              == family_blocks(path, cfg, len(ranks))
                              for r in ranks)}
    if PAR_FAMILIES[path][0] == "moe":
        checks[f"{path}_routes"] = \
            r0["f32_route_flip_share"] <= TOL_MOE_ROUTE_FLIPS
    return checks


def phase_parallel() -> dict:
    """The parallel strategies on 2 ranks sharing the card (see the module
    docstring); returns each path's launches summed over the ranks."""
    import tempfile

    import torch

    import chip_smoke
    from ray_tpu_torch.parallel import dryrun
    from ray_tpu_torch.parallel.launch import RankPool

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rows: dict = {}
    refs: dict = {}
    seconds: dict = {}
    ref_dir = tempfile.mkdtemp(prefix="rtt_parallel_")
    ref_path = os.path.join(ref_dir, "tp1_params.pt")
    try:
        ref = par_reference(ref_path, PAR_BATCH, PAR_SEQ, PAR_STEPS)
        with RankPool(PAR_RANKS, "cuda", timeout=PAR_TIMEOUT) as pool:
            for kind in ("tp", "fsdp"):
                rows[kind] = pool.run(chip_smoke.par_train_rank, kind,
                                      ref_path, PAR_BATCH, PAR_SEQ,
                                      PAR_STEPS)
            rows["ulysses"] = pool.run(chip_smoke.par_ulysses_rank,
                                       PAR_ULYSSES_SHAPE)
            rows["ring"] = pool.run(chip_smoke.par_ring_rank,
                                    PAR_RING_SHAPE)
            rows["moe"] = pool.run(chip_smoke.par_moe_rank)
            for kind in ("gpipe", "1f1b"):
                rows[kind] = pool.run(chip_smoke.par_pp_rank, kind)
            # The Megatron family paths, each against its unsplit step
            # run here while the ranks wait.
            for path in PAR_FAMILIES:
                t0 = time.perf_counter()
                path_ref = os.path.join(ref_dir, f"{path}.pt")
                refs[path] = par_family_reference(path, path_ref)
                rows[path] = pool.run(chip_smoke.par_family_rank, path,
                                      path_ref)
                os.remove(path_ref)
                seconds[path] = time.perf_counter() - t0
            # dryrun_multichip's ranks' work in these ranks.
            t0 = time.perf_counter()
            dry = pool.run(dryrun.dryrun_rank, PAR_RANKS, "cuda")[0]
            dryrun_s = time.perf_counter() - t0
    finally:
        for name in os.listdir(ref_dir):
            os.remove(os.path.join(ref_dir, name))
        os.rmdir(ref_dir)

    checks = parallel_checks(rows, ref["losses"], os.getpid())
    checks["dryrun"] = all(math.isfinite(dry[k]["loss"])
                           for k in ("gpt", "pipeline"))
    ref_step = statistics.median(ref["step_ms"][1:])
    for kind in ("tp", "fsdp"):
        r0 = rows[kind][0]
        emit(f"parallel_{kind}", ranks=PAR_RANKS, transport="gloo",
             config="gpt2_small", remat=True, batch=PAR_BATCH, seq=PAR_SEQ,
             dtype="bfloat16", steps=PAR_STEPS,
             losses=r0["losses"], tp1_losses=ref["losses"],
             loss_tol=TOL_PAR_LOSS, param_move_tol=TOL_PAR_PARAMS,
             max_param_move_err=max(r0["param_move_errs"]),
             max_param_err=max(r0["param_errs"]),
             grad_tol=TOL_PAR_GRADS, max_grad_err=max(r0["grad_errs"]),
             grad_errs=r0["grad_errs"],
             grad_control_errs=r0["grad_control_errs"],
             step_ms=[r["step_ms"] for r in rows[kind]],
             step_ms_median=statistics.median(r0["step_ms"][1:]),
             tp1_step_ms=ref["step_ms"], tp1_step_ms_median=ref_step,
             launches=[r["launches"] for r in rows[kind]],
             expected_launches=parallel_expected_launches(kind),
             collectives_per_step=[per_step(r["traffic"], PAR_STEPS)
                                   for r in rows[kind]],
             wqkv_block=r0["wqkv_block"], w1_block=r0["w1_block"],
             block_bytes=r0["block_bytes"], params_bytes=r0["params_bytes"],
             max_memory_allocated_gb=[r["max_memory_allocated_gb"]
                                      for r in rows[kind]])
    for kind in ("ulysses", "ring", "moe", "gpipe", "1f1b"):
        emit(f"parallel_{kind}", ranks=PAR_RANKS, transport="gloo",
             rows=[{k: (per_step(v, 1) if k == "traffic" else v)
                    for k, v in r.items()} for r in rows[kind]])
    for path, (family, axis, b, s) in PAR_FAMILIES.items():
        r0, ref_f = rows[path][0], refs[path]
        cfg = family_config(family)
        median = statistics.median(r0["step_ms"][1:])
        ref_median = statistics.median(ref_f["step_ms"][1:])
        emit(f"parallel_{path}", ranks=PAR_RANKS, transport="gloo",
             family=family, axis=axis, remat=cfg.remat, batch=b, seq=s,
             dtype="bfloat16", steps=PAR_STEPS, losses=r0["losses"],
             unsplit_losses=ref_f["losses"],
             route_flip_share=r0.get("route_flip_share"),
             f32_steps=PAR_F32_STEPS, f32_losses=r0["f32_losses"],
             unsplit_f32_losses=r0["ref_f32_losses"],
             f32_route_flip_share=r0.get("f32_route_flip_share"),
             f32_tol=TOL_PAR_F32, param_move_tol=TOL_PAR_PARAMS,
             max_param_move_err=max(r0["param_move_errs"]),
             max_param_err=max(r0["param_errs"]),
             max_grad_err=max(r0["grad_errs"]), grad_errs=r0["grad_errs"],
             grad_control_errs=r0["grad_control_errs"],
             step_ms=[r["step_ms"] for r in rows[path]],
             step_ms_median=median, unsplit_step_ms=ref_f["step_ms"],
             unsplit_step_ms_median=ref_median,
             step_ratio=median / ref_median,
             launches=[r["launches"] for r in rows[path]],
             expected_launches=parallel_expected_launches(path),
             collectives_per_step=[per_step(r["traffic"], PAR_STEPS)
                                   for r in rows[path]],
             bytes_reckoned=family_bytes(path, cfg, b, s),
             blocks=r0["blocks"], block_bytes=r0["block_bytes"],
             params_bytes=r0["params_bytes"],
             max_memory_allocated_gb=[r["max_memory_allocated_gb"]
                                      for r in rows[path]],
             unsplit_max_memory_allocated_gb=ref_f[
                 "max_memory_allocated_gb"],
             path_s=seconds[path])
    emit("parallel", ranks=PAR_RANKS, backend="gloo", device="cuda:0",
         transports=transports([{k: rows[k][i]["traffic"] for k in rows}
                                for i in range(PAR_RANKS)]),
         dryrun=dry, dryrun_s=dryrun_s,
         phase_s=time.perf_counter() - t_phase, checks=checks)
    failed = [name for name, ok in checks.items() if not ok]
    check(not failed, f"parallel checks failed: {failed}")

    def summed(kinds):
        return {n: sum(r["launches"][n] for k in kinds for r in rows[k])
                for n in rows[kinds[0]][0]["launches"]}

    return {"tp_train_ranks": summed(["tp"]),
            "fsdp_train_ranks": summed(["fsdp"]),
            "ulysses_ranks": summed(["ulysses"]),
            "pp_train_ranks": summed(["gpipe", "1f1b"]),
            **{f"{path}_train_ranks": summed([path])
               for path in PAR_FAMILIES}}


# The rllib phase: the port's RLlib on its own control plane. The card's
# host has no gymnasium and no ALE, so the environments are written here
# in numpy, with spaces that carry what the port reads of them.
class Box:
    """An observation or action space of float32 arrays (gymnasium's
    Box, as far as the port reads it)."""

    def __init__(self, low, high, shape):
        import numpy as np

        self.shape = tuple(shape)
        self.low = np.full(self.shape, low, np.float32)
        self.high = np.full(self.shape, high, np.float32)
        self.dtype = np.float32


class Discrete:
    """n actions, 0 .. n-1 (gymnasium's Discrete)."""

    def __init__(self, n: int):
        self.n, self.shape = int(n), ()


# The Atari frame-stack observation, 6 actions (Pong's and Breakout's
# action sets have 6 and 4): the Catalog builds its default CNN for it.
PIXEL_SHAPE, PIXEL_ACTIONS, PIXEL_EPISODE = (84, 84, 4), 6, 64


class PixelEnv:
    """(84, 84, 4) float32 frames in [0, 1] from a seeded numpy stream:
    dim noise, and one bright 12 x 12 patch whose place names the
    rewarded action (reward 1 for that action, else 0). The episode ends
    after 64 steps. A policy learns it only if the pixels reach it
    through the convolutions in the right layout."""

    def __init__(self, config=None):
        import numpy as np

        self.observation_space = Box(0.0, 1.0, PIXEL_SHAPE)
        self.action_space = Discrete(PIXEL_ACTIONS)
        self._rng = np.random.default_rng(0)
        self._t, self._target = 0, 0

    def _frame(self):
        import numpy as np

        self._target = int(self._rng.integers(PIXEL_ACTIONS))
        frame = self._rng.random(PIXEL_SHAPE, np.float32) * np.float32(0.3)
        row, col = 8 + 40 * (self._target // 3), 6 + 26 * (self._target % 3)
        frame[row:row + 12, col:col + 12, :] = 1.0
        return frame

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._frame(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._target else 0.0
        self._t += 1
        return self._frame(), reward, self._t >= PIXEL_EPISODE, False, {}

    def close(self):
        pass


class CartPoleEnv:
    """CartPole-v1's dynamics (gymnasium's classic_control/cartpole.py:
    Euler steps of 0.02 s, force 10 N, pole half-length 0.5 m), in numpy:
    reward 1 a step, terminated past 12 degrees or 2.4 m, truncated at
    500 steps."""

    GRAVITY, CART, POLE, HALF_LEN, FORCE, TAU = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    THETA_LIMIT, X_LIMIT, MAX_STEPS = 12 * 2 * math.pi / 360, 2.4, 500

    def __init__(self, config=None):
        import numpy as np

        self.observation_space = Box(-np.inf, np.inf, (4,))
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng(0)
        self._state = np.zeros(4)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4)
        self._t = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        import numpy as np

        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if int(action) == 1 else -self.FORCE
        cos, sin = math.cos(theta), math.sin(theta)
        total = self.CART + self.POLE
        pole_ml = self.POLE * self.HALF_LEN
        temp = (force + pole_ml * theta_dot ** 2 * sin) / total
        theta_acc = (self.GRAVITY * sin - cos * temp) / (
            self.HALF_LEN * (4.0 / 3.0 - self.POLE * cos ** 2 / total))
        x_acc = temp - pole_ml * theta_acc * cos / total
        x, x_dot = x + self.TAU * x_dot, x_dot + self.TAU * x_acc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._t += 1
        terminated = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT)
        truncated = self._t >= self.MAX_STEPS and not terminated
        return (self._state.astype(np.float32), 1.0, terminated, truncated,
                {})

    def close(self):
        pass


class TwoCartPoles:
    """A multi-agent env: agents "a0" and "a1", each on a CartPoleEnv of
    its own; the episode ends for both when either pole falls."""

    possible_agents = ["a0", "a1"]

    def __init__(self, config=None):
        self._envs = {a: CartPoleEnv() for a in self.possible_agents}
        self.observation_spaces = {a: e.observation_space
                                   for a, e in self._envs.items()}
        self.action_spaces = {a: e.action_space
                              for a, e in self._envs.items()}

    def reset(self, seed=None):
        return ({a: e.reset(seed=None if seed is None else seed + i)[0]
                 for i, (a, e) in enumerate(self._envs.items())}, {})

    def step(self, actions):
        out = {a: self._envs[a].step(act) for a, act in actions.items()}
        terms = {a: o[2] for a, o in out.items()}
        truncs = {a: o[3] for a, o in out.items()}
        terms["__all__"] = any(terms.values())
        truncs["__all__"] = any(truncs.values())
        return ({a: o[0] for a, o in out.items()},
                {a: o[1] for a, o in out.items()}, terms, truncs, {})

    def close(self):
        pass


def policy_of(agent_id: str) -> str:
    """TwoCartPoles' agent "a<i>" -> policy "p<i>"."""
    return "p" + agent_id[1:]


class PendulumEnv:
    """Pendulum-v1's dynamics (gymnasium's classic_control/pendulum.py:
    max speed 8, max torque 2, dt 0.05, g 10, m = l = 1), in numpy: obs
    [cos θ, sin θ, θ̇], reward -(θ² + 0.1 θ̇² + 0.001 u²) with θ
    normalized to [-π, π), truncated at 200 steps (gym.make's TimeLimit).
    Reset draws θ and θ̇ from one seeded generator as gymnasium does."""

    MAX_SPEED, MAX_TORQUE, DT, G, M, L, MAX_STEPS = 8, 2.0, 0.05, 10.0, \
        1.0, 1.0, 200

    def __init__(self, config=None):
        import numpy as np

        high = np.array([1.0, 1.0, self.MAX_SPEED], np.float32)
        self.observation_space = Box(-high, high, (3,))
        self.action_space = Box(-self.MAX_TORQUE, self.MAX_TORQUE, (1,))
        self._rng = np.random.default_rng(0)
        self._state = np.zeros(2)
        self._t = 0

    def _obs(self):
        import numpy as np

        theta, theta_dot = self._state
        return np.array([np.cos(theta), np.sin(theta), theta_dot],
                        np.float32)

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self._state = self._rng.uniform(low=-high, high=high)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        import numpy as np

        theta, theta_dot = self._state
        u = np.clip(action, -self.MAX_TORQUE, self.MAX_TORQUE)[0]
        normalized = ((theta + np.pi) % (2 * np.pi)) - np.pi
        costs = normalized ** 2 + 0.1 * theta_dot ** 2 + 0.001 * u ** 2
        theta_dot = theta_dot + (3 * self.G / (2 * self.L) * np.sin(theta)
                                 + 3.0 / (self.M * self.L ** 2) * u) \
            * self.DT
        theta_dot = np.clip(theta_dot, -self.MAX_SPEED, self.MAX_SPEED)
        self._state = np.array([theta + theta_dot * self.DT, theta_dot])
        self._t += 1
        return self._obs(), -costs, False, self._t >= self.MAX_STEPS, {}

    def close(self):
        pass


# DreamerV3's own frame size, 6 actions.
FRAMES_SHAPE, FRAMES_ACTIONS, FRAMES_EPISODE, FRAMES_CELL = (64, 64, 3), 6, \
    100, 8


class FramesEnv:
    """(64, 64, 3) float32 frames in [0, 1] (``config["shape"]`` another
    (H, W, C) of multiples of 8): a grid of 8-pixel cells, the agent lit
    (1.0) in the first channel and a goal (0.5) in the second (the first
    if there is one), over dim noise from a seeded stream. Actions 0-3
    move the agent up, down, left, right (clipped at the edges), 4 and 5
    hold it. Reaching the goal pays 1 and puts the goal elsewhere; the
    episode is truncated after 100 steps. The frames follow the actions,
    so a world model has dynamics to learn."""

    MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1), (0, 0), (0, 0))

    def __init__(self, config=None):
        import numpy as np

        self.shape = tuple((config or {}).get("shape", FRAMES_SHAPE))
        self.cells = (self.shape[0] // FRAMES_CELL,
                      self.shape[1] // FRAMES_CELL)
        self.observation_space = Box(0.0, 1.0, self.shape)
        self.action_space = Discrete(FRAMES_ACTIONS)
        self._rng = np.random.default_rng(0)
        self._agent, self._goal, self._t = (0, 0), (0, 0), 0

    def _cell(self):
        return tuple(int(self._rng.integers(0, n)) for n in self.cells)

    def _place_goal(self):
        while True:
            goal = self._cell()
            if goal != self._agent:
                self._goal = goal
                return

    def _frame(self):
        import numpy as np

        frame = self._rng.random(self.shape, np.float32) * np.float32(0.1)
        goal_channel = min(1, self.shape[2] - 1)
        for (row, col), channel, value in (
                (self._goal, goal_channel, 0.5), (self._agent, 0, 1.0)):
            frame[row * FRAMES_CELL:(row + 1) * FRAMES_CELL,
                  col * FRAMES_CELL:(col + 1) * FRAMES_CELL,
                  channel] = value
        return frame

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._agent = self._cell()
        self._place_goal()
        self._t = 0
        return self._frame(), {}

    def step(self, action):
        last = (self.cells[0] - 1, self.cells[1] - 1)
        d_row, d_col = self.MOVES[int(action)]
        self._agent = (min(max(self._agent[0] + d_row, 0), last[0]),
                       min(max(self._agent[1] + d_col, 0), last[1]))
        reward = 0.0
        if self._agent == self._goal:
            reward = 1.0
            self._place_goal()
        self._t += 1
        return (self._frame(), reward, False, self._t >= FRAMES_EPISODE,
                {})

    def close(self):
        pass


# The CNN PPO run: the repo's PPO defaults (minibatch 128, 4 epochs) on 2
# runners of 256 steps, so 16 learner updates an iteration, 3 iterations.
RLLIB_RUNNERS, RLLIB_FRAGMENT, RLLIB_ITERS, RLLIB_MINIBATCH = 2, 256, 3, 128
# Gradients of one CNN PPO minibatch (128 frames), card vs CPU from the
# same weights, f32 with no TF32, each leaf over its max|cpu|: the same
# products summed in other orders (cuDNN's convolution algorithms against
# the CPU's) through 5 convolutions and 2 dense layers, ~1e-6 relative in
# each sum; but a pre-activation within rounding of 0 takes the other
# side of a relu on the other device, and drops or adds that unit's
# whole contribution for the frame. f32 against f64 on the CPU reads up
# to 7.2e-3 for some weights (tests/test_torch_chip_smoke.py::
# TestRllibPhase); the card against the CPU read 3.7e-6 and 1.3e-3. The
# two planted faults (flatten in NCHW order; the odd SAME pixel padded
# before instead of after) move the gradients by O(1) (0.89 and above),
# and must fall outside the band.
TOL_RLLIB_GRADS = 2e-2
# A runner's value predictions against the driver's forward on the same
# host weights, both on the CPU.
TOL_RLLIB_SYNC = 1e-5


def grad_errs(grads, ref) -> dict:
    """Per leaf (dotted path) of two trees of dicts and lists:
    max |grads - ref| / max |ref|."""
    from ray_tpu_torch._tree import tree_paths

    ref = {k: r.detach().cpu() for k, r in tree_paths(ref).items()}
    return {k: float((g.detach().cpu() - ref[k]).abs().max()
                     / ref[k].abs().max().clamp(min=1e-30))
            for k, g in tree_paths(grads).items()}


def plant_fault(module, fault: str):
    """``module`` (a PPOModule over images) with a planted layout fault in
    its CNN: "nchw_flatten" flattens the conv features in C·H·W order
    (torch's own, not flax's H·W·C), "pads_before" puts the odd pixel of
    each asymmetric SAME pad before instead of after."""
    enc = module.net.encoder
    if fault == "nchw_flatten":
        enc.flatten = lambda x: x.reshape(x.shape[0], -1)
    elif fault == "pads_before":
        enc.pads = [(b, a, d, c) for a, b, c, d in enc.pads]
    else:
        raise ValueError(fault)
    return module


def rllib_minibatch(frags, gamma: float, size: int):
    """The first ``size`` rows of the GAE'd fragments, as PPO's learner
    gets a minibatch (no bootstrap: the fragments' ends count as cut)."""
    import numpy as np

    from ray_tpu_torch.rllib.algorithms.ppo import compute_gae

    frags = [compute_gae(f, gamma) for f in frags]
    keys = ("obs", "actions", "action_logp", "advantages", "value_targets")
    return {k: np.concatenate([f[k] for f in frags])[:size] for k in keys}


def time_calls(obj, name: str, log: list, keep: list = None) -> None:
    """Wrap ``obj.name`` so that each call's host seconds go to ``log``
    (and, with ``keep``, its result to ``keep``)."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log.append(time.perf_counter() - t0)
        if keep is not None:
            keep.append(out)
        return out

    setattr(obj, name, timed)


def finite_losses(stats: dict) -> bool:
    losses = [v for k, v in stats.items() if "loss" in k]
    return bool(losses) and all(math.isfinite(v) for v in losses)


def on_card(params) -> bool:
    from ray_tpu_torch._tree import tree_leaves

    return all(t.is_cuda for t in tree_leaves(params))


def runner_sync_err(algo, steps: int = 4) -> float:
    """The runners' value predictions on a fresh sample against the
    driver's forward on the learner's host weights: how far the weights
    the runners sample with are from the learner's."""
    import numpy as np
    import torch

    weights = algo.learner.get_weights()
    errs = []
    for frag in algo.env_runner_group.sample(steps):
        with torch.no_grad():
            _, values = algo.module.apply(weights, frag["obs"])
        ref = values.numpy()
        errs.append(float(np.abs(frag["vf_preds"] - ref).max()
                          / max(float(np.abs(ref).max()), 1e-30)))
    return max(errs)


def rllib_cartpole_paths() -> dict:
    """One iteration of each other path on CartPoleEnv, the learner on the
    card and one zero-GPU runner: recurrent PPO (LSTM, cell 128, chunks
    of 20), MultiAgentPPO with 2 policies, IMPALA, APPO, DQN with
    prioritized replay; then BC and MARWIL from a SampleWriter dataset
    of the recurrent PPO run's samples."""
    from ray_tpu_torch.rllib import (APPOConfig, BCConfig, DQNConfig,
                                     IMPALAConfig, MARWILConfig,
                                     MultiAgentPPOConfig, PPOConfig,
                                     SampleWriter)

    rows, kept = {}, []

    def run(name, config, keep_samples=False):
        t0 = time.perf_counter()
        algo = config.learners(device=None).debugging(seed=0).build()
        try:
            build_s = time.perf_counter() - t0
            if keep_samples:
                time_calls(algo.env_runner_group, "sample", [], kept)
            t0 = time.perf_counter()
            result = algo.train()
            train_s = time.perf_counter() - t0
            if algo.learner is None:  # MultiAgentPPO: a learner a policy
                learners = list(algo.learners.values())
                stats = {f"{mid}/{k}": v for mid in algo.learners
                         for k, v in result[mid].items()}
            else:
                learners, stats = [algo.learner], result
            rows[name] = {
                "build_s": build_s, "iteration_s": train_s,
                "steps": result["num_env_steps_sampled_lifetime"],
                "losses": {k: v for k, v in stats.items() if "loss" in k},
                "finite": finite_losses(stats),
                "on_card": all(on_card(ln.params) for ln in learners)}
        finally:
            algo.stop()

    def cartpole(config):
        return config.environment(CartPoleEnv).env_runners(
            num_env_runners=1, rollout_fragment_length=RLLIB_FRAGMENT)

    run("recurrent_ppo", cartpole(PPOConfig()).training(model={
        "use_lstm": True, "lstm_cell_size": 128, "max_seq_len": 20}),
        keep_samples=True)
    run("multi_agent_ppo", MultiAgentPPOConfig().environment(TwoCartPoles)
        .env_runners(num_env_runners=1,
                     rollout_fragment_length=RLLIB_FRAGMENT)
        .multi_agent(policies={"p0": None, "p1": None},
                     policy_mapping_fn=policy_of))
    run("impala", cartpole(IMPALAConfig()))
    run("appo", cartpole(APPOConfig()))
    run("dqn_per", cartpole(DQNConfig()).training(
        prioritized_replay=True, learning_starts=64))
    writer = SampleWriter()
    for frag in kept[0]:
        writer.write(frag)
    dataset = writer.to_dataset()
    for name, config in (("bc", BCConfig()), ("marwil", MARWILConfig())):
        run(name, config.environment(CartPoleEnv).training(
            offline_data=dataset))
    return rows


def phase_rllib():
    """The port's RLlib on its own control plane (ray_tpu_torch.init with
    4 CPUs and the GPU): PPO with the Catalog's default CNN at the Atari
    frame-stack shape, the learner on the card and 2 zero-GPU runners, 3
    iterations; the runners' samples after each weight sync against the
    driver's forward, and once after a sync of the learner's CUDA params
    themselves (nested CUDA tensors read without a card); one update's
    gradients card vs CPU with the two planted faults; then one iteration
    of each other path on CartPoleEnv. No K1-K3 launch is expected:
    nothing in RLlib reaches flash_attention. Runs on the cluster
    phase_rl starts."""
    import torch

    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.rllib import PPOConfig, PPOModule, TorchLearner

    t_phase = time.perf_counter()
    reset_launches()
    t0 = time.perf_counter()
    algo = (PPOConfig().environment(PixelEnv)
            .env_runners(num_env_runners=RLLIB_RUNNERS,
                         rollout_fragment_length=RLLIB_FRAGMENT)
            .training(minibatch_size=RLLIB_MINIBATCH, num_epochs=4)
            .learners(device=None).debugging(seed=0).build())
    build_s = time.perf_counter() - t0
    sample_s, update_s, frags, iters = [], [], [], []
    try:
        time_calls(algo.env_runner_group, "sample", sample_s, frags)
        time_calls(algo.learner, "update", update_s)
        for _ in range(RLLIB_ITERS):
            n_samples, n_updates = len(sample_s), len(update_s)
            t0 = time.perf_counter()
            result = algo.train()
            wall = time.perf_counter() - t0
            sampled, learned = sample_s[n_samples], sum(
                update_s[n_updates:])
            last_frags = frags[n_samples]
            iters.append({
                "iteration_s": wall, "sample_s": sampled,
                "learn_s": learned, "sample_share": sampled / wall,
                "learn_share": learned / wall,
                "updates": len(update_s) - n_updates,
                "env_steps": RLLIB_RUNNERS * RLLIB_FRAGMENT,
                "env_steps_per_s": RLLIB_RUNNERS * RLLIB_FRAGMENT / wall,
                "losses": {k: v for k, v in result.items()
                           if "loss" in k},
                "episode_return_mean": result["episode_return_mean"],
                "finite": finite_losses(result),
                # the runners sample again after the sync train()
                # ended with
                "runner_sync_err": runner_sync_err(algo)})
        # The learner's own CUDA params, nested in a dict, to the
        # zero-GPU runners: each reads CPU tensors.
        algo.env_runner_group.sync_weights(algo.learner.params)
        cuda_sync_err = runner_sync_err(algo)
        algo.env_runner_group.sync_weights(algo.learner.get_weights())
        learner_on_card = on_card(algo.learner.params)

        # One update card vs CPU on a fixed minibatch of 128 frames.
        batch = rllib_minibatch(last_frags, algo.config.gamma,
                                RLLIB_MINIBATCH)
        weights = algo.learner.get_weights()
        loss_fn = algo.learner.loss_fn

        def learner_on(device, fault=None):
            module = PPOModule(PIXEL_SHAPE, PIXEL_ACTIONS)
            if fault:
                plant_fault(module, fault)
            ln = TorchLearner(module, loss_fn, device=device)
            ln.set_weights(weights)
            return ln

        cpu = learner_on("cpu")
        cpu_loss, _, cpu_grads = cpu.compute_gradients(batch)
        card = learner_on(None)
        card_loss, _, card_grads = card.compute_gradients(batch)
        errs = grad_errs(card_grads, cpu_grads)
        faults = {}
        for fault in ("nchw_flatten", "pads_before"):
            _, _, g = learner_on(None, fault).compute_gradients(batch)
            faults[fault] = max(grad_errs(g, cpu_grads).values())
        card.apply_gradients(card_grads)
        cpu.apply_gradients(cpu_grads)
        param_errs = grad_errs(card.params, cpu.params)
        # The update alone, on the card: the median of 20 after 3.
        for _ in range(3):
            card.update(batch)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            card.update(batch)
            times.append(time.perf_counter() - t0)
        n_params = sum(t.numel() for t in
                       tree_leaves(algo.learner.params))
    finally:
        algo.stop()
    ppo_s = time.perf_counter() - t_phase
    paths = rllib_cartpole_paths()
    launches = dict(_kernels.LAUNCHES)
    phase_s = time.perf_counter() - t_phase
    emit("rllib_ppo_cnn", obs_shape=list(PIXEL_SHAPE),
         actions=PIXEL_ACTIONS, params=n_params,
         conv_filters=[list(f) for f in algo.module.net.encoder.filters],
         runners=RLLIB_RUNNERS, fragment=RLLIB_FRAGMENT,
         minibatch=RLLIB_MINIBATCH, build_s=build_s, iterations=iters,
         update_ms_median=statistics.median(update_s) * 1e3,
         update_ms_min=min(update_s) * 1e3,
         fixed_batch_update_ms_median=statistics.median(times) * 1e3,
         learner_on_card=learner_on_card, cuda_sync_err=cuda_sync_err,
         sync_tol=TOL_RLLIB_SYNC, phase_ppo_s=ppo_s)
    emit("rllib_vs_cpu", frames=RLLIB_MINIBATCH, dtype="float32",
         loss_card=card_loss.item(), loss_cpu=cpu_loss.item(),
         max_grad_err=max(errs.values()), grad_errs=errs,
         tol=TOL_RLLIB_GRADS, planted_fault_errs=faults,
         post_adam_param_errs_max=max(param_errs.values()))
    emit("rllib", paths=paths, launches=launches, phase_s=phase_s)
    check(learner_on_card, "the PPO learner's params are not on the card")
    check(all(it["finite"] for it in iters), f"PPO losses: {iters}")
    check(all(it["updates"] == 16 for it in iters),
          f"updates per iteration: {[it['updates'] for it in iters]}")
    check(all(it["runner_sync_err"] <= TOL_RLLIB_SYNC for it in iters)
          and cuda_sync_err <= TOL_RLLIB_SYNC,
          f"runners sample with other weights than the learner's: "
          f"{[it['runner_sync_err'] for it in iters]}, {cuda_sync_err}")
    check(max(errs.values()) <= TOL_RLLIB_GRADS,
          f"CNN PPO gradients card vs CPU: {errs}")
    check(all(e > TOL_RLLIB_GRADS for e in faults.values()),
          f"the band {TOL_RLLIB_GRADS} passes a planted fault: {faults}")
    bad = {k: r for k, r in paths.items()
           if not (r["finite"] and r["on_card"])}
    check(not bad, f"rllib paths failed: {bad}")
    check(set(launches.values()) == {0},
          f"RLlib launched attention kernels: {launches}")
    torch.cuda.empty_cache()

# The off-policy and model-based phases: SAC and TD3 on the numpy
# Pendulum at the configs' own batch (256) and width (64, 64), CQL from
# SAC's samples, and DreamerV3 at the JAX package's default width on
# DreamerV3's own 64x64x3 frames.
OFFPOLICY_ITERS, OFFPOLICY_FRAGMENT, OFFPOLICY_STARTS = 3, 200, 256
# Gradients of one 256-row batch card vs CPU from the same weights and
# noise, f32 with no TF32, each leaf over its max|cpu|. The products are
# tiny (64 wide), but a saturated tanh action leaves SAC's log-Jacobian
# log(1 - a² + 1e-6) and tanh's backward 1 - a² with two digits: one ulp
# of tanh between two implementations moved an actor leaf 1.7e-2 of its
# max on 16 rows (tests/test_torch_rllib_algorithms.py), and f32 against
# f64 on the CPU reads up to TestOffPolicyPhase's measure on 256 rows.
# f32 against f64 on the CPU reads up to 3.4e-3 (test_torch_chip_smoke.py::
# TestOffPolicyPhase). The planted faults (the actor loss's Q call under
# no_grad; CQL's observations tiled, obs.repeat(n, 1), instead of each
# repeated n times) move the actor's gradients, or the conservative
# penalty's own (held beside CQL's whole update: the Bellman term, ~100
# on Pendulum's rewards, hides the penalty in the sum), by O(1).
TOL_OFFPOLICY_GRADS = 5e-2
# TD3's params after two steps on one batch, card vs CPU, in Adam steps
# (|card - cpu| / lr) over the elements whose first gradient is at least
# 1e-4 of its leaf's max (a smaller one's first step may take either
# sign). The planted fault, the actor and its Adam state stepped on the
# held step, moves every actor element by about one step.
TOL_TD3_STEPS = 5e-2
TD3_KEEP = 1e-4
# DreamerV3 at the JAX package's defaults (dreamerv3.py:120-122, 583-594):
# 256 deterministic units, 8 x 8 categoricals, hidden 256, cnn_depth 16,
# 41 bins, sequences of 16, 8 a batch, an imagination horizon of 15.
DREAMER_WIDTHS = dict(n_deter=256, n_cat=8, n_classes=8, cnn_depth=16,
                      critic_bins=41, seq_len=16, batch_sequences=8,
                      horizon=15)
DREAMER_HIDDEN, DREAMER_ITERS, DREAMER_FRAGMENT, DREAMER_STARTS = 256, 3, \
    64, 128
# Its gradients card vs CPU on one batch, same params and noise, each leaf
# over its max|cpu|, f32 with no TF32: 16 recurrent steps and 15 imagined
# ones through a GRU, 4 convolutions and 4 transposed ones. A categorical
# sample whose two best classes lie within rounding of each other may
# take the other class on the other device, and changes that latent's
# whole path; such flips are counted beside the band, never absorbed by
# it. silu, not relu: no unit flips sides. f32 against f64 on the CPU
# reads up to 1.9e-6 at this width (TestDreamerPhase measures it at a
# small one). The planted faults (the deconv kernel unflipped; the
# straight-through term dropped, z = one_hot; the two-hot's bin one too
# high) move the world model's or the critic's gradients by 0.68 or more.
TOL_DREAMER_GRADS = 1e-3


class TimedUpdate:
    """An algorithm's update (SACUpdate, TD3Update, DreamerUpdate) whose
    calls are timed on the host clock, each ended by a synchronize of the
    card; everything else is the update's own."""

    def __init__(self, update, log: list):
        self._update, self._log = update, log

    def __getattr__(self, name):
        return getattr(self._update, name)

    def __call__(self, *args):
        import torch

        t0 = time.perf_counter()
        out = self._update(*args)
        torch.cuda.synchronize()
        self._log.append(time.perf_counter() - t0)
        return out


def tree_err(grads, ref) -> float:
    """max |grads - ref| over every leaf / max |ref| over every leaf."""
    from ray_tpu_torch._tree import tree_paths

    ref = {k: r.detach().cpu() for k, r in tree_paths(ref).items()}
    scale = max(float(r.abs().max()) for r in ref.values())
    return max(float((g.detach().cpu() - ref[k]).abs().max())
               for k, g in tree_paths(grads).items()) / max(scale, 1e-30)


def step_errs(params, ref, first_grads, lr: float,
              keep: float = TD3_KEEP) -> dict:
    """Per leaf: max |params - ref| / lr, in Adam steps, over the
    elements whose first gradient is at least ``keep`` of the leaf's
    max |gradient|."""
    from ray_tpu_torch._tree import tree_paths

    ref = {k: r.detach().cpu() for k, r in tree_paths(ref).items()}
    grads = {k: g.detach().cpu()
             for k, g in tree_paths(first_grads).items()}
    out = {}
    for k, p in tree_paths(params).items():
        g = grads[k].abs()
        mask = g >= keep * g.max().clamp(min=1e-30)
        diff = (p.detach().cpu() - ref[k]).abs()[mask]
        out[k] = float(diff.max() / lr) if diff.numel() else 0.0
    return out


def plant_rl_fault(update, fault: str):
    """``update`` (on the card) with a planted fault:
    "actor_q_no_grad" (SAC: the actor loss's Q call under no_grad, which
    cuts the actor's gradient through the critic), "repeat_tiles" (CQL:
    the observations tiled, obs.repeat(n, 1), so the reshape to [B, N]
    pairs each row with another observation's actions),
    "actor_every_step" (TD3: the actor and its Adam state stepped on the
    held steps too), "deconv_unflipped" (DreamerV3: the transposed
    convolutions' kernels not flipped), "no_straight_through" (z =
    one_hot, no gradient through the sample), "bin_one_high" (the
    two-hot's bin index without its -1)."""
    import torch

    if fault == "actor_q_no_grad":
        held = type(update).actor_q

        def actor_q(params, obs, action):
            with torch.no_grad():
                return held(update, params, obs, action)

        update.actor_q = actor_q
    elif fault == "repeat_tiles":
        pen = update.critic_penalty
        pen.repeat = lambda obs: obs.repeat(pen.n, 1)
    elif fault == "actor_every_step":
        update.actor_step_due = lambda step: True
    elif fault == "deconv_unflipped":
        update.module.deconv_kernel = lambda w: w.permute(2, 3, 0, 1)
    elif fault == "no_straight_through":
        update.module.straight_through = lambda one_hot, probs: one_hot
    elif fault == "bin_one_high":
        m = update.module
        m.bin_index = lambda y: torch.searchsorted(m._bins(y), y,
                                                   right=True)
    else:
        raise ValueError(fault)
    return update


def to_device(tree, device):
    """A tree's tensors on ``device`` (copies)."""
    from ray_tpu_torch._tree import tree_map

    return tree_map(lambda t, _: t.to(device, copy=True), tree)


def off_policy_card_vs_cpu(name: str, algo, batch) -> dict:
    """One update's gradients (SAC, CQL) or two updates' params (TD3) on
    the card against the CPU, from the algorithm's weights and one draw
    of noise, and the same on the card with the planted fault."""
    import torch

    from ray_tpu_torch.rllib.algorithms.cql import make_cql_penalty
    from ray_tpu_torch.rllib.algorithms.sac import make_sac_update
    from ray_tpu_torch.rllib.algorithms.td3 import (TD3Module,
                                                     make_td3_update)
    from ray_tpu_torch.rllib.core.learner import device_batch, gradients
    from ray_tpu_torch.rllib.core.rl_module import SACModule

    cfg, weights = algo.config, algo.get_weights()
    ex, dims = cfg.extra, (algo.module.obs_dim, algo.module.num_actions)

    def update_on(device):
        if name == "td3":
            return make_td3_update(
                TD3Module(*dims, cfg.hidden), cfg.gamma, cfg.lr,
                float(ex.get("tau", 0.005)), int(ex.get("policy_delay", 2)),
                float(ex.get("target_noise", 0.2)),
                float(ex.get("noise_clip", 0.5)), device=device)
        module = SACModule(*dims, cfg.hidden)
        penalty = make_cql_penalty(module, float(ex.get("cql_alpha", 1.0)),
                                   int(ex.get("n_cql_actions", 8))) \
            if name == "cql" else None
        return make_sac_update(module, cfg.gamma, cfg.lr,
                               float(ex.get("tau", 0.005)),
                               float(ex.get("target_entropy", -dims[1])),
                               critic_penalty_fn=penalty, device=device)

    cpu = update_on("cpu")
    noise = cpu.noise(len(batch["rewards"]),
                      torch.Generator().manual_seed(1))
    host = device_batch(batch, torch.device("cpu"))

    def run(update):
        """SAC: one update's gradients; CQL: those, and its conservative
        penalty's own gradients. TD3: the params after two updates, and
        the first one's gradients."""
        dev = update.device
        state = update.init_state(params=weights)
        b, n = to_device(host, dev), to_device(noise, dev)
        if name == "sac":
            return update.gradients(state, b, n)[1]
        if name == "cql":
            p = state["params"]
            q1, q2 = update.module.apply_q(p, b["obs"], b["actions"])
            penalty, _ = update.critic_penalty(p, b, q1, q2, n)
            return {"update": update.gradients(state, b, n)[1],
                    "penalty": gradients(penalty, p["q"])}
        p = state["params"]
        first = {"q": gradients(update.critic_loss(p["q"], state["target"],
                                                   b, n), p["q"]),
                 "actor": gradients(update.actor_loss(p["actor"], p["q"],
                                                      b), p["actor"])}
        for _ in range(2):
            update(state, b, n)
        return state["params"], first

    fault = {"sac": "actor_q_no_grad", "cql": "repeat_tiles",
             "td3": "actor_every_step"}[name]
    cpu_out = run(cpu)
    card_out = run(update_on(None))
    bad_out = run(plant_rl_fault(update_on(None), fault))
    if name == "td3":
        # In Adam steps, over the elements whose first gradient (the
        # CPU's) is clear.
        (cpu_params, first), (card_params, _), (bad_params, _) = \
            cpu_out, card_out, bad_out
        errs = step_errs(card_params, cpu_params, first, cfg.lr)
        fault_errs = step_errs(bad_params, cpu_params, first, cfg.lr)
        return {"measure": "adam_steps", "tol": TOL_TD3_STEPS,
                "errs": errs, "max_err": max(errs.values()),
                "planted_fault": fault,
                "planted_fault_err": max(fault_errs.values())}
    if name == "cql":
        # The penalty's bias gradients cancel to rounding (logsumexp's
        # weights sum to the data term's 1), so its leaves are taken
        # over the penalty gradient's largest element, not their own.
        errs = {**{f"update.{k}": v for k, v in
                   grad_errs(card_out["update"], cpu_out["update"]).items()},
                "penalty": tree_err(card_out["penalty"], cpu_out["penalty"])}
        fault_errs = {"update": max(grad_errs(bad_out["update"],
                                              cpu_out["update"]).values()),
                      "penalty": tree_err(bad_out["penalty"],
                                          cpu_out["penalty"])}
    else:
        errs = grad_errs(card_out, cpu_out)
        fault_errs = grad_errs(bad_out, cpu_out)
    return {"measure": "grad_of_leaf_max", "tol": TOL_OFFPOLICY_GRADS,
            "errs": errs, "max_err": max(errs.values()),
            "planted_fault": fault,
            "planted_fault_err": max(fault_errs.values())}


def off_policy_run(name: str, config) -> dict:
    """``OFFPOLICY_ITERS`` iterations of SAC or TD3 with the learner on
    the card: per iteration its seconds, the sampling's, and the
    updates' (each ended by a synchronize); then the card-vs-CPU
    check on one batch of its replay."""
    import numpy as np
    import torch

    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.rllib.algorithms.sac import update_on

    t0 = time.perf_counter()
    algo = config.learners(device=None).debugging(seed=0).build()
    build_s = time.perf_counter() - t0
    sample_s, update_s, frags, iters = [], [], [], []
    try:
        time_calls(algo.env_runner_group, "sample", sample_s, frags)
        algo._update = TimedUpdate(algo._update, update_s)
        for _ in range(OFFPOLICY_ITERS):
            n_samples, n_updates = len(sample_s), len(update_s)
            t0 = time.perf_counter()
            result = algo.train()
            wall = time.perf_counter() - t0
            learned = sum(update_s[n_updates:])
            iters.append({
                "iteration_s": wall, "sample_s": sample_s[n_samples],
                "sample_share": sample_s[n_samples] / wall,
                "learn_s": learned, "learn_share": learned / wall,
                "updates": len(update_s) - n_updates,
                "losses": {k: v for k, v in result.items() if "loss" in k},
                "finite": finite_losses(result) if result.get("q_loss")
                is not None else None,
                "episode_return_mean": result["episode_return_mean"]})
        on = on_card(algo._state["params"])
        n_params = sum(t.numel() for t in tree_leaves(algo._state["params"]))
        profile_device(lambda: (update_on(
            algo._update._update, algo._state,
            algo.buffer.sample(algo.config.train_batch_size),
            algo._generator), torch.cuda.synchronize()),
            "rllib_offpolicy_profile", f"one {name} update (B=256)")
        vs_cpu = off_policy_card_vs_cpu(
            name, algo, algo.buffer.sample(algo.config.train_batch_size))
        trained = [it for it in iters if it["updates"]]
        return {"algo": algo, "frags": frags, "row": {
            "params": n_params, "build_s": build_s, "iterations": iters,
            "updates": len(update_s),
            "update_ms_median": statistics.median(update_s) * 1e3
            if update_s else None,
            "update_ms_min": min(update_s) * 1e3 if update_s else None,
            "learner_on_card": on,
            "finite": bool(trained) and all(it["finite"] for it in trained),
            "vs_cpu": vs_cpu, "returns_finite": bool(np.isfinite(
                iters[-1]["episode_return_mean"]))}}
    except BaseException:
        algo.stop()
        raise


def phase_rllib_offpolicy() -> None:
    """SAC and TD3 on PendulumEnv (1 zero-GPU runner of 200 steps, the
    learner on the card, learning_starts 256, 16 updates of 256 an
    iteration, 3 iterations), each checked card vs CPU with its planted
    fault; then CQL for an iteration from a SampleWriter dataset of SAC's
    samples, checked the same way."""
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.rllib import (CQLConfig, SACConfig, SampleWriter,
                                     TD3Config)

    t_phase = time.perf_counter()
    reset_launches()
    rows, kept = {}, []
    for name, config in (("sac", SACConfig()), ("td3", TD3Config())):
        config = (config.environment(PendulumEnv)
                  .env_runners(num_env_runners=1,
                               rollout_fragment_length=OFFPOLICY_FRAGMENT)
                  .training(learning_starts=OFFPOLICY_STARTS,
                            updates_per_iter=16))
        out = off_policy_run(name, config)
        try:
            rows[name] = out["row"]
            if name == "sac":
                kept = out["frags"]
        finally:
            out["algo"].stop()
    writer = SampleWriter()
    for frags in kept:  # each sample() call's fragments, one a runner
        for frag in frags:
            writer.write(frag)
    t0 = time.perf_counter()
    cql = (CQLConfig().environment(PendulumEnv)
           .training(offline_data=writer.to_dataset())
           .learners(device=None).debugging(seed=0).build())
    build_s = time.perf_counter() - t0
    update_s = []
    cql._update = TimedUpdate(cql._update, update_s)
    t0 = time.perf_counter()
    result = cql.train()
    rows["cql"] = {
        "rows": len(writer), "build_s": build_s,
        "iteration_s": time.perf_counter() - t0, "updates": len(update_s),
        "update_ms_median": statistics.median(update_s) * 1e3,
        "losses": {k: v for k, v in result.items() if "loss" in k
                   or k == "cql_penalty"},
        "finite": finite_losses(result),
        "learner_on_card": on_card(cql._state["params"]),
        "vs_cpu": off_policy_card_vs_cpu(
            "cql", cql, next(cql.reader.iter_batches()))}
    launches = dict(_kernels.LAUNCHES)
    emit("rllib_offpolicy", env="PendulumEnv (numpy, Pendulum-v1)",
         paths=rows, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    for name, row in rows.items():
        check(row["learner_on_card"], f"{name}: params not on the card")
        check(row["finite"], f"{name}: losses not finite: {row}")
        check(row["updates"] > 0, f"{name}: no update ran")
        v = row["vs_cpu"]
        check(v["max_err"] <= v["tol"],
              f"{name} card vs CPU: {v['max_err']} > {v['tol']}: "
              f"{v['errs']}")
        check(v["planted_fault_err"] > v["tol"],
              f"{name}: the band {v['tol']} passes the planted fault "
              f"{v['planted_fault']}: {v['planted_fault_err']}")
    check(rows["sac"]["params"] == 13_636,
          f"SAC params: {rows['sac']['params']}")
    check(all(rows[n]["updates"] == 16 * (OFFPOLICY_ITERS - 1)
              for n in ("sac", "td3")),
          f"updates: {[rows[n]['updates'] for n in ('sac', 'td3')]}")
    check(set(launches.values()) == {0},
          f"RLlib launched attention kernels: {launches}")


def categorical_flips(card, cpu, weights, batch, noise) -> dict:
    """The categorical samples of one batch that differ between the card
    and the CPU: the posterior's latents, and the imagined actions and
    latents (each update's imagination from its own posterior)."""
    import torch

    def samples(update, b, n):
        m = update.module
        state = update.init_state(params=weights)
        wm, actor, _ = update.split(state["params"])
        with torch.no_grad():
            _, (hs, zs, _) = update.world_model_loss(wm, b, n)
            feats, acts, _ = update.imagine(wm, actor, hs, zs, n)
        cat = lambda z: z.reshape(z.shape[:-1] + (m.n_cat, m.n_classes)) \
            .argmax(-1).cpu()  # noqa: E731
        return (cat(zs), acts.cpu(), cat(feats[..., m.n_deter:]))

    ours = samples(card, to_device(batch, card.device),
                   to_device(noise, card.device))
    ref = samples(cpu, batch, noise)
    names = ("posterior_latents", "imagined_actions", "imagined_latents")
    return {name: {"flips": int((a != b).sum()), "of": int(a.numel())}
            for name, a, b in zip(names, ours, ref)}


def dreamer_card_vs_cpu(algo) -> dict:
    """One update's gradients on the card against the CPU from the
    algorithm's weights, one batch of its replay and one draw of noise;
    the categorical flips between them; and the planted faults."""
    import torch

    from ray_tpu_torch.rllib.algorithms.dreamerv3 import (
        DreamerModule, make_dreamer_update)

    weights, cfg = algo.get_weights(), algo.config
    batch = to_device(algo.sample_batch(), "cpu")
    m = algo.module

    def update_on(device):
        module = DreamerModule(m.obs_shape, m.num_actions,
                               n_deter=m.n_deter, n_cat=m.n_cat,
                               n_classes=m.n_classes, hidden=m.hidden,
                               cnn_depth=DREAMER_WIDTHS["cnn_depth"],
                               n_bins=m.n_bins)
        return make_dreamer_update(
            module, horizon=DREAMER_WIDTHS["horizon"], gamma=cfg.gamma,
            device=device)

    cpu = update_on("cpu")
    noise = cpu.noise(batch["rewards"].shape[0], batch["rewards"].shape[1],
                      torch.Generator().manual_seed(2))

    def grads(update):
        state = update.init_state(params=weights)
        metrics, g = update.gradients(state, to_device(batch, update.device),
                                      to_device(noise, update.device))
        return metrics, g

    cpu_metrics, cpu_grads = grads(cpu)
    card = update_on(None)
    card_metrics, card_grads = grads(card)
    errs = {group: grad_errs(card_grads[group], cpu_grads[group])
            for group in ("wm", "actor", "critic")}
    faults = {}
    for fault in ("deconv_unflipped", "no_straight_through",
                  "bin_one_high"):
        _, g = grads(plant_rl_fault(update_on(None), fault))
        faults[fault] = max(max(grad_errs(g[k], cpu_grads[k]).values())
                            for k in g)
    return {"tol": TOL_DREAMER_GRADS,
            "max_err": {k: max(v.values()) for k, v in errs.items()},
            "worst_leaves": {k: max(v, key=v.get) for k, v in errs.items()},
            "flips": categorical_flips(card, cpu, weights, batch, noise),
            "losses_card": {k: float(v) for k, v in card_metrics.items()
                            if "loss" in k},
            "losses_cpu": {k: float(v) for k, v in cpu_metrics.items()
                           if "loss" in k},
            "planted_fault_errs": faults}


def phase_dreamer() -> None:
    """DreamerV3 at the JAX package's default width on FramesEnv's 64x64x3
    frames (6 actions; the conv plan 64 -> 32 -> 16 -> 8 -> 4, depth 16 to
    128, 2,351,124 params), the learner on the card and 1 zero-GPU runner
    of 64 steps, learning_starts 128 so that 2 of 3 iterations train (4
    updates each): update ms (median and min, each ended by a
    synchronize), its share of the iteration, the losses, the runner's
    seconds a step; one more update under torch.profiler (device ms by
    group, launches, idle share); then one update's gradients card vs
    CPU, the categorical flips, and three planted faults."""
    import torch

    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.rllib import DreamerV3Config

    t_phase = time.perf_counter()
    reset_launches()
    t0 = time.perf_counter()
    algo = (DreamerV3Config().environment(FramesEnv)
            .env_runners(num_env_runners=1,
                         rollout_fragment_length=DREAMER_FRAGMENT)
            .training(learning_starts=DREAMER_STARTS,
                      model={"hidden": [DREAMER_HIDDEN]}, **DREAMER_WIDTHS)
            .learners(device=None).debugging(seed=0).build())
    build_s = time.perf_counter() - t0
    sample_s, update_s, iters = [], [], []
    try:
        time_calls(algo.env_runner_group, "sample", sample_s)
        algo._update = TimedUpdate(algo._update, update_s)
        for _ in range(DREAMER_ITERS):
            n_samples, n_updates = len(sample_s), len(update_s)
            t0 = time.perf_counter()
            result = algo.train()
            wall = time.perf_counter() - t0
            learned = sum(update_s[n_updates:])
            iters.append({
                "iteration_s": wall, "sample_s": sample_s[n_samples],
                "runner_s_per_step": sample_s[n_samples] / DREAMER_FRAGMENT,
                "learn_s": learned, "update_share": learned / wall,
                "updates": len(update_s) - n_updates,
                "losses": {k: v for k, v in result.items()
                           if k in ("wm_loss", "actor_loss", "critic_loss",
                                    "wm_recon", "wm_kl")}})
        on = on_card(algo._state["params"])
        n_params = sum(t.numel() for t in tree_leaves(algo._state["params"]))
        update, batch = algo._update._update, algo.sample_batch()
        noise = update.noise(*batch["rewards"].shape, algo._generator)
        profile_device(lambda: (update(algo._state, batch, noise),
                                torch.cuda.synchronize()),
                       "dreamer_profile",
                       "one DreamerV3 update (B=8, L=16, H=15)")
        vs_cpu = dreamer_card_vs_cpu(algo)
    finally:
        algo.stop()
    launches = dict(_kernels.LAUNCHES)
    trained = [it for it in iters if it["updates"]]
    emit("dreamer", obs_shape=list(FRAMES_SHAPE), actions=FRAMES_ACTIONS,
         params=n_params, conv_shapes=[list(s) for s in
                                       algo.module.conv_shapes],
         hidden=DREAMER_HIDDEN, **DREAMER_WIDTHS, build_s=build_s,
         iterations=iters, updates=len(update_s),
         update_ms_median=statistics.median(update_s) * 1e3,
         update_ms_min=min(update_s) * 1e3, learner_on_card=on,
         vs_cpu=vs_cpu, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    check(on, "DreamerV3's params are not on the card")
    check(n_params == 2_351_124, f"DreamerV3 params: {n_params}")
    check(len(trained) == 2 and all(it["updates"] == 4 for it in trained),
          f"DreamerV3 updates per iteration: "
          f"{[it['updates'] for it in iters]}")
    check(all(math.isfinite(v) for it in trained
              for v in it["losses"].values()),
          f"DreamerV3 losses: {[it['losses'] for it in trained]}")
    worst = max(vs_cpu["max_err"].values())
    check(worst <= TOL_DREAMER_GRADS,
          f"DreamerV3 gradients card vs CPU: {vs_cpu['max_err']} "
          f"(flips {vs_cpu['flips']})")
    check(all(e > TOL_DREAMER_GRADS
              for e in vs_cpu["planted_fault_errs"].values()),
          f"the band {TOL_DREAMER_GRADS} passes a planted fault: "
          f"{vs_cpu['planted_fault_errs']}")
    check(set(launches.values()) == {0},
          f"DreamerV3 launched attention kernels: {launches}")


def phase_rl() -> None:
    """The RLlib phases on one cluster of the port (4 CPUs, the GPU):
    rllib, rllib_offpolicy, dreamer."""
    import torch

    import ray_tpu_torch as rt

    rt.init(num_cpus=4, num_gpus=1)
    try:
        phase_rllib()
        phase_rllib_offpolicy()
        phase_dreamer()
    finally:
        rt.shutdown()
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

    t_start = time.perf_counter()
    seconds: dict = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    peaks = timed("device", phase_device)
    designs = timed("build", phase_build)
    compared = timed("compare", phase_compare, peaks)
    compared_bwd = timed("compare_bwd", phase_compare_bwd, peaks)
    compared_norm = timed("compare_norm", phase_compare_norm, peaks)
    compared_qkv = timed("compare_qkv_rope", phase_compare_qkv_rope, peaks)
    over_limit = timed("heads_over_limit", phase_heads_over_limit, peaks)
    serving, slice_ctx = timed("slice", phase_slice)
    dag_fused = timed("dag_fused", phase_dag_fused, slice_ctx)
    del slice_ctx
    timed("online", phase_online)
    timed("runtime", phase_runtime)
    pool_actor = timed("serve_llm+processor", phase_control_plane)
    multinode = timed("multinode", phase_multinode)
    autoscale = timed("autoscale", phase_autoscale)
    cli_client = timed("cli_client", phase_cli_client)
    trained = timed("train", phase_train, peaks)
    train_dp = timed("train_dp", phase_train_dp, peaks,
                     trained[True]["losses"])
    train_feed = timed("train_feed", phase_train_feed, peaks)
    libraries = timed("libraries", phase_libraries,
                      trained[True]["losses"][0])
    parallel = timed("parallel", phase_parallel)
    timed("train_vs_cpu", phase_train_vs_cpu)
    timed("train_profile", phase_train_profile)
    llama = timed("llama_train", phase_llama_train, peaks)
    timed("llama_vs_cpu", phase_llama_vs_cpu)
    vit = timed("vit", phase_vit)
    moe = timed("moe", phase_moe)
    timed("resnet", phase_resnet)
    timed("rllib+rllib_offpolicy+dreamer", phase_rl)
    emit("phase_seconds", seconds=seconds,
         total_s=time.perf_counter() - t_start)

    # Launches on each main path, each counted over exactly its run:
    # the batch serving slice, its 8 greedy steps as CUDA-graph replays
    # of the fused DAG, the same stage's call inside a Data pool actor
    # (counted in that process), the same stage's call in a pool actor on
    # a node daemon and the autoscaled daemon's attention task (each
    # counted in its process), the same stage's cold call submitted by a
    # client driver to the CLI's node (counted in its worker) and the
    # Pool actor's 4 attention calls (counted in its process), one
    # GPT-2-small train step with remat (the preset) and one without, the
    # 5 steps of the Train worker and the 5 fed ViT steps of the
    # train_feed worker (each counted in its process), every step of the libraries phase's Tune trials (summed
    # over the trials' processes) and its workflow's GPU step (summed
    # over that step's runs), the parallel phase's tp=2 and fsdp=2 steps,
    # Ulysses, pipelines and the llama, ViT and MoE tp=2 and MoE ep=2
    # steps (each summed over its 2 ranks' processes), one
    # llama, ViT and MoE train step each, and one ViT classifier call.
    pool = {name: pool_actor[name] for name in serving}
    paths = {"serving": serving, "dag_fused_replays": dag_fused,
             "processor_pool_actor": pool, "multinode": multinode,
             "autoscale": autoscale, **cli_client,
             "train": trained[True]["launches"],
             "train_no_remat": trained[False]["launches"],
             "train_dp_worker": train_dp["launches"],
             "train_feed_worker": train_feed, **libraries, **parallel,
             "llama_train": llama["launches"], **vit, "moe_train": moe}
    by_path = {name: {path: launches.get(name, 0)
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
    gpt_norm = compared_norm["gpt"]
    for name, key in (("rms_norm_fwd", "y_err"), ("rms_norm_bwd", "dx_err"),
                      ("rms_norm_dw", "dw_err")):
        # rms_norm_bwd's times hold rms_norm_dw's, which the wrapper
        # launches after it; the forward's are its own.
        times = ("fwd_ms", "fwd_bound_ms") if name == "rms_norm_fwd" \
            else ("bwd_ms", "bwd_bound_ms")
        kernels.append({
            "name": name, "route": "cuda",
            "design": kernel_design(designs, name)
            or designs.get(f"{name}_f32_kernel", ""),
            "source": "ray_tpu_torch/ops/csrc/rms_norm.cu",
            "replaces": "none (ray_tpu/ops/layers.py::rms_norm is plain "
                        "jnp)",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_err": max(r[key] for r in compared_norm.values()
                           if key in r),
            "shape": gpt_norm["shape"], "dtype": gpt_norm["dtype"],
            "cases": {case: {k: r[k] for k in (
                "shape", "dtype", "kind", "y_err", "dx_err", "dw_err",
                "fwd_ms", "bwd_ms", "ms", "fwd_bound_ms", "bwd_bound_ms",
                "bound_ms",
                "bound_ratio", "plain_ms", "library_ms") if k in r}
                for case, r in compared_norm.items() if "ms" in r},
            **{k: gpt_norm[k] for k in times},
        })
    gpt_qkv = compared_qkv["gpt"]
    for name, way in (("qkv_rope_fwd", "fwd"), ("qkv_rope_bwd", "bwd")):
        kernels.append({
            "name": name, "route": "cuda",
            "design": designs.get(f"{name}_bf16_kernel", ""),
            "source": "ray_tpu_torch/ops/csrc/qkv_rope.cu",
            "replaces": "none (the JAX package's qkv split and "
                        "ray_tpu/ops/layers.py::rope are plain jnp)",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "bit_identical": all(all(r["bit_identical"].values())
                                 for r in compared_qkv.values()),
            "shape": gpt_qkv["shape"], "dtype": gpt_qkv["dtype"],
            "ms": gpt_qkv[f"{way}_ms"], "bound_ms": gpt_qkv["bound_ms"],
            "cases": {case: {k: r[k] for k in (
                "shape", "dtype", "kind", "fwd_ms", "bwd_ms", "bound_ms",
                "fwd_bound_ratio", "bwd_bound_ratio", "plain_ms") if k in r}
                for case, r in compared_qkv.items() if "fwd_ms" in r},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
