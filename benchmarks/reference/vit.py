"""Plain ViT reference: the forward, the loss and a training step in
blocks of rows.

The architecture is the one the program runs (see the configuration's
``departures`` for where it leaves the published ViT-B/16): NHWC images
cut into patches by reshapes and projected by one product, a CLS token
and a learned position table added, blocks with RMSNorm, full attention
and tanh GELU and no biases, and the head on the normed CLS token.
Weights come as a dict of float32 tensors in the program's layout:
``patch`` [P*P*C, d], ``cls`` [1, 1, d], ``pos`` [patches + 1, d],
``lnf``, ``head`` [d, classes] and ``layers`` as in the GPT reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .common import Matmul, attention, cross_entropy_sum, gelu_tanh, rms_norm


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[b, H, W, C] -> [b, patches, P*P*C], rows of patches in order."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (h // patch) * (w // patch), patch * patch * c)


def logits(params: Dict, images: torch.Tensor, patch: int, heads: int,
           mm: Matmul) -> torch.Tensor:
    x = mm(patchify(images, patch), params["patch"])
    b, _, d = x.shape
    x = torch.cat([params["cls"].expand(b, 1, d), x], dim=1)
    x = x + params["pos"][None, :x.shape[1]]
    s, hd = x.shape[1], d // heads
    for layer in params["layers"]:
        y = rms_norm(x, layer["ln1"])
        q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2)
                   for t in mm(y, layer["wqkv"]).split(d, dim=-1))
        a = attention(q, k, v, False, mm).transpose(1, 2).reshape(b, s, d)
        x = x + mm(a, layer["wo"])
        y = rms_norm(x, layer["ln2"])
        x = x + mm(gelu_tanh(mm(y, layer["w1"])), layer["w2"])
    return mm(rms_norm(x[:, 0], params["lnf"]), params["head"])


def loss_and_grads(params: Dict, images: torch.Tensor, labels: torch.Tensor,
                   patch: int, heads: int, mm: Matmul,
                   leaves: List[torch.Tensor], rows_per_block: int
                   ) -> Tuple[float, List[torch.Tensor]]:
    """The mean cross entropy over the batch and its gradient for each of
    ``leaves``, accumulated over blocks of ``rows_per_block`` images."""
    n = images.shape[0]
    grads = [torch.zeros_like(p) for p in leaves]
    total = 0.0
    for lo in range(0, n, rows_per_block):
        for p in leaves:
            p.requires_grad_(True)
        part = cross_entropy_sum(
            logits(params, images[lo:lo + rows_per_block], patch, heads, mm),
            labels[lo:lo + rows_per_block]) / n
        got = torch.autograd.grad(part, leaves)
        for g, d in zip(grads, got):
            g.add_(d)
        total += float(part.detach())
        for p in leaves:
            p.requires_grad_(False)
    return total, grads
