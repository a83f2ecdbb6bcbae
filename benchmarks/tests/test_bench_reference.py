"""The plain references against the program on the CPU at a tiny size,
both in float32 on the same weights: GPT and ViT losses and gradients,
the AdamW step, and the batch-generation stage's tokens."""

import numpy as np
import pytest
import torch

from benchmarks import compare, harness
from benchmarks.families import gpt as gpt_family
from benchmarks.families import vit as vit_family
from benchmarks.reference import gpt as ref_gpt
from benchmarks.reference import vit as ref_vit
from benchmarks.reference.common import (MATMULS, AdamW, full_float32,
                                         leaves, to_fp8)

GPT = {"n_embd": 32, "n_layer": 2, "n_head": 4, "n_inner": None,
       "n_positions": 64, "vocab_size": 90, "padded_vocab_size": 96,
       "tie_word_embeddings": True, "dtype": "float32", "remat": False}
VIT = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
       "intermediate_size": 64, "image_size": 16, "patch_size": 4,
       "num_channels": 3, "num_labels": 7, "dtype": "float32",
       "remat": False}
CPU = torch.device("cpu")


def close(a, b, tol=2e-5):
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def port_grads(loss_fn, params):
    named = leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    loss = loss_fn()
    grads = torch.autograd.grad(loss, [t for _, t in named])
    for _, t in named:
        t.requires_grad_(False)
    return float(loss.detach()), grads


def test_gpt_loss_and_gradients_match_the_program():
    from ray_tpu_torch.models.gpt import gpt_loss

    cfg = gpt_family.port_config(GPT)
    params = harness.make_params(gpt_family.leaf_specs(GPT), 11, CPU)
    rows = torch.randint(0, 90, (3, 17), generator=torch.Generator()
                         .manual_seed(1))
    batch = rows[:, :-1], rows[:, 1:]
    want, want_g = port_grads(lambda: gpt_loss(params, batch, cfg), params)
    tensors = [t for _, t in leaves(params)]
    got, got_g = ref_gpt.loss_and_grads(params, *batch, 4,
                                        MATMULS["float32"], tensors, 2)
    assert got == pytest.approx(want, rel=1e-5)
    for a, b in zip(got_g, want_g):
        assert close(a, b)


def test_vit_loss_and_gradients_match_the_program():
    from ray_tpu_torch.models.vit import vit_loss

    cfg = vit_family.port_config(VIT)
    params = harness.make_params(vit_family.leaf_specs(VIT), 12, CPU)
    g = torch.Generator().manual_seed(2)
    batch = (torch.randn(5, 16, 16, 3, generator=g),
             torch.randint(0, 7, (5,), generator=g))
    want, want_g = port_grads(lambda: vit_loss(params, batch, cfg), params)
    tensors = [t for _, t in leaves(params)]
    got, got_g = ref_vit.loss_and_grads(params, *batch, 4, 4,
                                        MATMULS["float32"], tensors, 2)
    assert got == pytest.approx(want, rel=1e-5)
    for a, b in zip(got_g, want_g):
        assert close(a, b)


def test_adamw_matches_the_programs_optimizer():
    from ray_tpu_torch.models._training import default_optimizer

    g = torch.Generator().manual_seed(3)
    p = [torch.randn(5, 4, generator=g), torch.ones(3)]
    q = [t.clone().requires_grad_(True) for t in p]
    ours, theirs = AdamW(p, [torch.float32] * 2), default_optimizer(q)
    for _ in range(3):
        grads = [torch.randn(t.shape, generator=g) for t in p]
        ours.step(grads)
        for t, gr in zip(q, grads):
            t.grad = gr.clone()
        theirs.step()
    for a, b in zip(p, q):
        assert close(a, b.detach(), 1e-6)


def test_stage_tokens_are_the_references_greedy_choice():
    from ray_tpu_torch.llm.batch import GPTInferenceStage

    params = harness.make_params(gpt_family.leaf_specs(GPT), 13, CPU)
    stage = GPTInferenceStage(config=gpt_family.port_config(GPT),
                              params=params, max_new_tokens=5,
                              device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 90, size=n) for n in (9, 20, 30)]
    col = np.empty(3, object)
    for i, p in enumerate(prompts):
        col[i] = p
    served = stage({"tokens": col})["generated_tokens"]
    bucket = ref_gpt.stage_bucket([len(p) for p in prompts], 64)
    assert bucket == 32
    with torch.no_grad(), full_float32():
        for p, s in zip(prompts, served):
            s = torch.as_tensor(s).long()
            w = ref_gpt.stage_windows(torch.as_tensor(p), s, bucket, 96)
            logits = ref_gpt.last_logits(params, w, 4, MATMULS["float32"])
            assert float(compare.logit_gaps(logits, s).max()) <= 1e-4


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(5))
    e8 = float(((to_fp8(x) - x).abs() / x.abs().clamp_min(1e-3)).median())
    e16 = float(((x.bfloat16().float() - x).abs()
                 / x.abs().clamp_min(1e-3)).median())
    assert e8 > 8 * e16


def test_norm_gap_reads_a_state_left_unchanged_as_one():
    ref = {"a": 2.0, "b": 1.0, "c": 3.0}
    assert compare.norm_gap({}, ref) == pytest.approx(1.0)
    assert compare.norm_gap(ref, ref) == 0.0
