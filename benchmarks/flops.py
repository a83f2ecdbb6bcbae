"""Operation and byte counts from shapes, and the chip's published peaks.

Frozen arithmetic of the benchmark: model FLOPs of a training step and of
a KV-cached greedy decode, and the roofline bound of one attention kernel
launch. Nothing here reads a trace or times anything; the metric readers
divide these counts by times taken from the trace.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores, HBM bytes/s. Matched on the name
# torch.cuda.get_device_name() gives, the first key contained in it.
PEAKS = [
    ("H100 PCIe", {"bf16": 756e12, "f32": 51e12, "bytes": 2.0e12}),
    ("H100 NVL", {"bf16": 835e12, "f32": 60e12, "bytes": 3.9e12}),
    ("H200", {"bf16": 989e12, "f32": 67e12, "bytes": 4.8e12}),
    ("H100", {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12}),  # SXM
]


def peaks_for(name: str) -> Dict:
    """The peaks of the card called ``name`` (the H100 SXM's when no key
    matches), with the key that matched."""
    for key, peak in PEAKS:
        if key in name:
            return {"matched": key, **peak}
    return {"matched": "H100 (default)", **PEAKS[-1][1]}


def attention_bound(shape: Sequence[int], dtype_bytes: int, causal: bool,
                    peak: float, bw: float, matmuls: int = 2,
                    tensors: int = 4, rows: int = 0) -> Tuple[float, str]:
    """(bound in seconds, what bounds it) of one attention kernel launch
    over [B, H, S, D]: ``tensors`` [B, H, S, D] read or written once and
    ``rows`` f32 [B, H, S] read or written once, against the FLOPs of
    ``matmuls`` products over the (causal) pairs. K1: 2 products, q, k,
    v read and o written (and lse written when the backward needs it).
    K2: 3 products; q, k, v, dO and O read, dq written, lse read, delta
    written. K3: 4 products; q, k, v and dO read, dk and dv written, lse
    and delta read."""
    b, h, s, d = shape
    nbytes = tensors * b * h * s * d * dtype_bytes + rows * b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * matmuls * b * h * d * pairs
    t_bytes, t_ops = nbytes / bw, flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# (matmuls, tensors, rows) of each kernel's launch, as attention_bound
# takes them. K1 in a training step writes lse; under inference it does
# not.
KERNEL_TRAFFIC = {
    "flash_fwd": (2, 4, 1),
    "flash_fwd_infer": (2, 4, 0),
    "flash_bwd_dq": (3, 6, 2),
    "flash_bwd_dkv": (4, 6, 2),
}


def kernel_bound(kernel: str, shape: Sequence[int], causal: bool,
                 peaks: Dict, dtype_bytes: int = 2) -> float:
    """Seconds one launch of ``kernel`` over ``shape`` needs at least."""
    matmuls, tensors, rows = KERNEL_TRAFFIC[kernel]
    return attention_bound(shape, dtype_bytes, causal, peaks["bf16"],
                           peaks["bytes"], matmuls, tensors, rows)[0]


def _block_flops(tokens: int, d: int, f: int) -> int:
    """Forward FLOPs of one block's dense products over ``tokens``: the
    q, k, v and output projections and the two MLP matmuls."""
    return 2 * tokens * (4 * d * d + 2 * d * f)


def _attention_flops(rows: int, heads: int, head_dim: int, seq: int,
                     causal: bool) -> int:
    """Forward FLOPs of QK^T and PV over the pairs one layer computes."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    return 4 * rows * heads * head_dim * pairs


def gpt_train_flops(d: int, layers: int, heads: int, f: int, vocab: int,
                    batch: int, seq: int) -> int:
    """Model FLOPs of one GPT training step with no recompute: 3 x the
    forward (the backward is twice the forward), where the forward is
    each layer's products and causal attention plus the tied head,
    counted once. The embedding lookup does no arithmetic."""
    tokens = batch * seq
    fwd = layers * (_block_flops(tokens, d, f)
                    + _attention_flops(batch, heads, d // heads, seq, True))
    fwd += 2 * tokens * d * vocab
    return 3 * fwd


def vit_train_flops(d: int, layers: int, heads: int, f: int, classes: int,
                    image: int, patch: int, channels: int,
                    batch: int) -> int:
    """Model FLOPs of one ViT training step with no recompute: each
    layer's products and full attention over the patches and the CLS
    token, 3 x the forward; the patch projection's backward takes only
    the weight gradient (the images need none), so it counts 2 x; the
    head reads the CLS token alone."""
    patches = (image // patch) ** 2
    seq = patches + 1
    tokens = batch * seq
    blocks = layers * (_block_flops(tokens, d, f)
                       + _attention_flops(batch, heads, d // heads, seq,
                                          False))
    embed = 2 * batch * patches * (patch * patch * channels) * d
    head = 2 * batch * d * classes
    return 3 * (blocks + head) + 2 * embed


def gpt_decode_flops(d: int, layers: int, heads: int, f: int, vocab: int,
                     prompt: int, new_tokens: int) -> int:
    """Forward FLOPs a KV-cached greedy decode of one row needs: the
    prompt's positions once (no padding) and each generated token but the
    last once through the blocks, attention of each position over its
    own real context, and the head only where a token is chosen
    (``new_tokens`` times)."""
    positions = prompt + new_tokens - 1
    blocks = layers * (_block_flops(positions, d, f)
                       + 4 * heads * (d // heads)
                       * positions * (positions + 1) // 2)
    return blocks + new_tokens * 2 * d * vocab
