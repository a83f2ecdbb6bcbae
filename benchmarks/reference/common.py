"""Plain pieces the reference models share: their matrix product (float32
with TF32 off, or the float8 control), RMSNorm, rotary embedding, plain
attention, cross entropy and AdamW.

The reference imports nothing of the program under test and takes none of
its tensors: the harness hands it the inputs and weights it made itself.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


@contextlib.contextmanager
def full_float32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN, and
    the previous settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to e4m3's 448), back in float32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x.float() * scale).to(FP8).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """A product of float8 operands, summed in float32, and its gradient
    from float8 operands too: the lower-precision control."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(grad)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # Broadcast batch dims of an operand are summed back.
        while db.dim() > qb.dim():
            db = db.sum(0)
        while da.dim() > qa.dim():
            da = da.sum(0)
        return da, db


def matmul_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


MATMULS: Dict[str, Matmul] = {"float32": matmul_f32, "fp8": matmul_fp8}


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


def rope(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over [batch, heads, seq, head_dim], the two halves
    of head_dim rotated as pairs, positions 0..seq-1."""
    seq, dim = x.shape[-2], x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=x.device) / dim))
    ang = torch.arange(seq, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, mm: Matmul) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [batch, heads, seq, d]."""
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        s = q.shape[-2]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def cross_entropy_sum(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of ``targets`` under ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long()).sum()


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


class AdamW:
    """AdamW as the program states it (lr 3e-4, betas 0.9 and 0.999, eps
    1e-8, decay 0.01 on every leaf), computed in float32. Each leaf is
    stored after every step in the dtype the configuration gives its
    weights (``storage``), as the program stores them; the moments stay
    in float32."""

    def __init__(self, params: List[torch.Tensor],
                 storage: List[torch.dtype], lr: float = 3e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.params, self.storage = params, storage
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v, dt in zip(self.params, grads, self.m, self.v,
                                  self.storage):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            new = p * (1 - self.lr * self.wd) - self.lr * (m / bc1) / (
                (v / bc2).sqrt() + self.eps)
            p.copy_(new.to(dt).float())
