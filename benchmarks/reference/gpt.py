"""Plain GPT reference: the forward, the loss, a training step in blocks of
rows, and the greedy choice of the batch-generation stage.

The architecture is the one the program runs (see the configuration's
``departures`` for where it leaves GPT-2's published description):
RMSNorm, rotary q and k, causal attention, tanh GELU, no biases, the tied
embedding as the head. Weights come as a dict of float32 tensors in the
program's layout: ``embed`` [vocab, d], ``lnf`` [d] and ``layers``, each
with ``ln1``, ``wqkv`` [d, 3d] (q | k | v), ``wo``, ``ln2``, ``w1``,
``w2``. Every product goes through ``mm`` (float32, or the float8
control).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .common import (Matmul, attention, cross_entropy_sum, gelu_tanh,
                     rms_norm, rope)


def backbone(params: Dict, tokens: torch.Tensor, heads: int,
             mm: Matmul) -> torch.Tensor:
    """tokens [b, s] -> the normed last hidden states [b, s, d]."""
    x = params["embed"][tokens]
    b, s, d = x.shape
    hd = d // heads
    for layer in params["layers"]:
        y = rms_norm(x, layer["ln1"])
        q, k, v = mm(y, layer["wqkv"]).split(d, dim=-1)
        q = rope(q.reshape(b, s, heads, hd).transpose(1, 2))
        k = rope(k.reshape(b, s, heads, hd).transpose(1, 2))
        v = v.reshape(b, s, heads, hd).transpose(1, 2)
        a = attention(q, k, v, True, mm).transpose(1, 2).reshape(b, s, d)
        x = x + mm(a, layer["wo"])
        y = rms_norm(x, layer["ln2"])
        x = x + mm(gelu_tanh(mm(y, layer["w1"])), layer["w2"])
    return rms_norm(x, params["lnf"])


def last_logits(params: Dict, tokens: torch.Tensor, heads: int,
                mm: Matmul) -> torch.Tensor:
    """Logits [b, vocab] of the last position of each row."""
    x = backbone(params, tokens, heads, mm)[:, -1]
    return mm(x, params["embed"].t())


def loss_sum(params: Dict, tokens: torch.Tensor, targets: torch.Tensor,
             heads: int, mm: Matmul) -> torch.Tensor:
    """Summed next-token cross entropy over every position."""
    x = backbone(params, tokens, heads, mm)
    logits = mm(x.reshape(-1, x.shape[-1]), params["embed"].t())
    return cross_entropy_sum(logits, targets.reshape(-1))


def loss_and_grads(params: Dict, tokens: torch.Tensor,
                   targets: torch.Tensor, heads: int, mm: Matmul,
                   leaves: List[torch.Tensor], rows_per_block: int
                   ) -> Tuple[float, List[torch.Tensor]]:
    """The mean loss over the batch and its gradient for each of
    ``leaves`` (the float32 tensors inside ``params``), accumulated over
    blocks of ``rows_per_block`` rows so that the batch fits."""
    n = tokens.numel()
    grads = [torch.zeros_like(p) for p in leaves]
    total = 0.0
    for lo in range(0, tokens.shape[0], rows_per_block):
        for p in leaves:
            p.requires_grad_(True)
        part = loss_sum(params, tokens[lo:lo + rows_per_block],
                        targets[lo:lo + rows_per_block], heads, mm) / n
        got = torch.autograd.grad(part, leaves)
        for g, d in zip(grads, got):
            g.add_(d)
        total += float(part.detach())
        for p in leaves:
            p.requires_grad_(False)
    return total, grads


def stage_windows(prompt: torch.Tensor, served: torch.Tensor,
                  bucket: int, vocab: int) -> torch.Tensor:
    """The inputs the batch-generation stage reads at each generated
    token, [new_tokens, bucket]: the prompt (its last ``bucket`` ids,
    modulo the vocabulary) left-padded with id 0 to the bucket, then the
    window slid by one token per step with the served tokens appended."""
    p = prompt[-bucket:] % vocab
    row = torch.zeros(bucket + served.numel(), dtype=torch.long,
                      device=prompt.device)
    row[bucket - p.numel():bucket] = p
    row[bucket:] = served
    return torch.stack([row[j:j + bucket] for j in range(served.numel())])


def stage_bucket(lengths: List[int], max_seq: int) -> int:
    """The bucket the stage pads a batch to: the smallest power of two
    from 8 up that holds its longest prompt, at most ``max_seq``."""
    b = 8
    while b < max(lengths):
        b *= 2
    return min(b, max_seq)
