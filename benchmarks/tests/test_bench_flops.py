"""flops.py against FLOPs counted by hand for a tiny GPT and ViT, the
attention bound, and the peaks table."""

import pytest

from benchmarks import flops


def test_gpt_train_flops_tiny_by_hand():
    # d=4, 1 layer, 2 heads (head_dim 2), f=8, vocab 10, batch 1, seq 3.
    # Per token: qkv 2*4*12=96, wo 2*4*4=32, w1 2*4*8=64, w2 2*8*4=64
    # -> 256 a token, 768 for 3 tokens. Causal pairs 1+2+3=6; QK^T and
    # PV: 2 products * 2 flops * 2 heads * 2 dims * 6 pairs = 96. Head:
    # 2*4*10 a token = 240. Forward 768+96+240 = 1104; a step 3x.
    assert flops.gpt_train_flops(4, 1, 2, 8, 10, 1, 3) == 3 * 1104


def test_vit_train_flops_tiny_by_hand():
    # image 4, patch 2, 1 channel: 4 patches of 4 values, seq 5. d=4,
    # 1 layer, 2 heads, f=8, 3 classes, batch 1. Blocks 256 a token * 5
    # = 1280; full pairs 25: 2*2*2*2*25 = 400; head 2*4*3 = 24; patch
    # projection 2*4*4*4 = 128, weight gradient only in the backward.
    assert flops.vit_train_flops(4, 1, 2, 8, 3, 4, 2, 1, 1) == \
        3 * (1280 + 400 + 24) + 2 * 128


def test_gpt_decode_flops_tiny_by_hand():
    # prompt 2, 2 new tokens: 3 positions through the blocks (the last
    # token is never fed): 256*3 = 768; attention over contexts 1, 2, 3:
    # 4 * 2 heads * 2 dims * 6 = 96; head twice: 2 * 2*4*10 = 160.
    assert flops.gpt_decode_flops(4, 1, 2, 8, 10, 2, 2) == 768 + 96 + 160


def test_gpt2_small_step_is_52_tflop():
    assert flops.gpt_train_flops(768, 12, 12, 3072, 50304, 64, 1024) == \
        pytest.approx(52.3e12, rel=2e-3)


def test_attention_bound_picks_the_larger():
    peaks = {"bf16": 1e12, "bytes": 1e12}
    # [1,1,4,2] causal K1 with lse: bytes 4*8*2 + 4*4 = 80; flops
    # 2*2*1*1*2*10 = 80: a tie goes to bytes.
    t, by = flops.attention_bound((1, 1, 4, 2), 2, True, 1e12, 1e12, 2, 4,
                                  1)
    assert (t, by) == (80e-12, "bytes")
    assert flops.kernel_bound("flash_fwd", (1, 1, 4, 2), True, peaks) == t
    t2, by2 = flops.attention_bound((1, 1, 64, 2), 2, False, 1e12, 1e12)
    assert by2 == "operations" and t2 == 2 * 2 * 2 * 64 * 64 * 1e-12


def test_peaks():
    assert flops.peaks_for("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert flops.peaks_for("NVIDIA H100 PCIe")["matched"] == "H100 PCIe"
    assert flops.peaks_for("unknown")["bytes"] == 3.35e12
