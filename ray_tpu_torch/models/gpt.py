"""Flagship model: decoder-only transformer (GPT family).

Counterpart of ``ray_tpu/models/gpt.py``: the same config fields and
presets, the same param dict (keys, shapes, init scales), so weights
converted from the JAX package load as they are. Matmuls run in the
model dtype, norms and softmax in f32, attention through
``ops.flash_attention`` (the Hopper kernel on CUDA).

``gpt_loss`` is the chunked next-token cross entropy and
``make_train_step`` the AdamW train step over it (``models/_training.py``).
``remat`` checkpoints each block: its activations are recomputed in the
backward instead of kept.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import rms_norm, rope
from ._init import normal
from ._training import make_train_step_for


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    tie_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def gpt2_small(cls) -> "GPTConfig":
        """GPT-2 124M-equivalent."""
        return cls(vocab_size=50304, d_model=768, n_heads=12, n_layers=12,
                   d_ff=3072, max_seq_len=1024)

    @classmethod
    def tiny(cls) -> "GPTConfig":
        return cls(vocab_size=512, d_model=64, n_heads=4, n_layers=2,
                   d_ff=128, max_seq_len=128)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_init(cfg: GPTConfig, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    out_scale = scale / (2 * cfg.n_layers) ** 0.5
    ones = torch.ones(d, dtype=torch.float32, device=device)
    return {
        "ln1": ones,
        "wqkv": normal((d, 3 * d), scale, cfg.dtype, generator, device),
        "wo": normal((d, d), out_scale, cfg.dtype, generator, device),
        "ln2": ones.clone(),
        "w1": normal((d, f), scale, cfg.dtype, generator, device),
        "w2": normal((f, d), out_scale, cfg.dtype, generator, device),
    }


def gpt_init(cfg: GPTConfig, generator: torch.Generator,
             device: DeviceLike = None) -> Dict:
    """Random params with the JAX package's keys, shapes and scales.

    Draws come from ``generator`` (a CPU one gives the same weights on
    every device). They differ from ``jax.random``'s; parity tests convert
    JAX weights with ``models.convert.from_jax_params`` instead."""
    device = resolve_device(device)
    params = {
        "embed": normal((cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5,
                        cfg.dtype, generator, device),
        "lnf": torch.ones(cfg.d_model, dtype=torch.float32, device=device),
        "layers": [_layer_init(cfg, generator, device)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, cfg.vocab_size),
                                cfg.d_model ** -0.5, cfg.dtype, generator,
                                device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _block(x: torch.Tensor, layer: Dict, cfg: GPTConfig) -> torch.Tensor:
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    # Attention
    y = rms_norm(x, layer["ln1"])
    q, k, v = (y @ layer["wqkv"]).split(d, dim=-1)
    q = rope(q.reshape(b, s, h, hd).transpose(1, 2))
    k = rope(k.reshape(b, s, h, hd).transpose(1, 2))
    v = v.reshape(b, s, h, hd).transpose(1, 2).contiguous()
    attn = flash_attention(q, k, v, True, None)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + attn @ layer["wo"]
    # MLP: jax.nn.gelu's default is the tanh form.
    y = rms_norm(x, layer["ln2"])
    x = x + F.gelu(y @ layer["w1"], approximate="tanh") @ layer["w2"]
    return x


def _head(params: Dict) -> torch.Tensor:
    head = params.get("head")
    return params["embed"].T if head is None else head


def _backbone(params: Dict, tokens: torch.Tensor,
              cfg: GPTConfig) -> torch.Tensor:
    """Embedding + blocks + final norm: [b, s] -> [b, s, d]."""
    x = params["embed"][tokens]
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            # The JAX package keeps the matmul outputs of each block
            # (policy dots_with_no_batch_dims_saveable); torch's
            # checkpoint keeps only the block's input and recomputes the
            # whole block in the backward. The values are the same; that
            # policy is not ported.
            x = checkpoint(_block, x, layer, cfg, use_reentrant=False)
        else:
            x = _block(x, layer, cfg)
    return rms_norm(x, params["lnf"])


def gpt_forward(params: Dict, tokens: torch.Tensor,
                cfg: GPTConfig) -> torch.Tensor:
    """tokens [batch, seq] int -> logits [batch, seq, vocab] (fp32)."""
    x = _backbone(params, tokens, cfg)
    return (x @ _head(params)).float()


_LOSS_CHUNK = 4096


def gpt_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
             cfg: GPTConfig) -> torch.Tensor:
    """Next-token cross entropy; batch = (tokens, targets) [b, s].

    Chunked over rows as the JAX package does: the largest power of two
    up to ``_LOSS_CHUNK`` that divides the rows, each chunk's [chunk,
    vocab] logits in f32, the log-likelihoods summed in f32. A row count
    with no such divisor above 1 takes the unchunked form."""
    tokens, targets = batch
    x = _backbone(params, tokens, cfg)
    head = _head(params)
    xf = x.reshape(-1, x.shape[-1])
    tf = targets.reshape(-1).long()
    rows = xf.shape[0]
    chunk = _LOSS_CHUNK
    while chunk > 1 and rows % chunk:
        chunk //= 2
    if chunk <= 1:
        logits = (xf @ head).float()
        ll = F.log_softmax(logits, dim=-1).gather(1, tf[:, None])[:, 0]
        return -ll.mean()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, rows, chunk):
        lg = (xf[start:start + chunk] @ head).float()
        tgt = lg.gather(1, tf[start:start + chunk, None])[:, 0]
        total = total + (tgt - torch.logsumexp(lg, dim=-1)).sum()
    return -total / rows


# ---------------------------------------------------------------------------
# training step
# ---------------------------------------------------------------------------
def make_train_step(cfg: GPTConfig, optimizer=None,
                    device: DeviceLike = None):
    """Build (init_state, train_step) for ``cfg`` on ``device`` (None: the
    CUDA card; raises without one). ``optimizer`` maps the list of params
    to a ``torch.optim.Optimizer`` (default: AdamW as the JAX package's
    ``optax.adamw(3e-4, weight_decay=0.01)``). See
    ``_training.make_train_step_for``."""
    device = resolve_device(device)
    return make_train_step_for(
        lambda generator: gpt_init(cfg, generator, device),
        lambda params, batch: gpt_loss(params, batch, cfg),
        optimizer=optimizer, device=device)
