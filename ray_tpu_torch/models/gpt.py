"""Flagship model: decoder-only transformer (GPT family).

Counterpart of ``ray_tpu/models/gpt.py``: the same config fields and
presets, the same param dict (keys, shapes, init scales), so weights
converted from the JAX package load as they are. Matmuls run in the
model dtype, norms and softmax in f32, attention through
``ops.flash_attention`` (the Hopper kernel on CUDA).

The loss and the train step come with the training slice; ``remat`` is
kept as a field for config parity and is not read on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import rms_norm, rope


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
def _normal(shape, std: float, cfg: GPTConfig, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    # Drawn in f32 on the generator's device, scaled, then cast: a CPU
    # generator gives the same weights on every device.
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(device=device, dtype=cfg.dtype)


def _layer_init(cfg: GPTConfig, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    out_scale = scale / (2 * cfg.n_layers) ** 0.5
    ones = torch.ones(d, dtype=torch.float32, device=device)
    return {
        "ln1": ones,
        "wqkv": _normal((d, 3 * d), scale, cfg, generator, device),
        "wo": _normal((d, d), out_scale, cfg, generator, device),
        "ln2": ones.clone(),
        "w1": _normal((d, f), scale, cfg, generator, device),
        "w2": _normal((f, d), out_scale, cfg, generator, device),
    }


def gpt_init(cfg: GPTConfig, generator: torch.Generator,
             device: DeviceLike = None) -> Dict:
    """Random params with the JAX package's keys, shapes and scales.

    Draws come from ``generator`` (a CPU one gives the same weights on
    every device). They differ from ``jax.random``'s; parity tests convert
    JAX weights with ``models.convert.from_jax_params`` instead."""
    device = resolve_device(device)
    params = {
        "embed": _normal((cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5,
                         cfg, generator, device),
        "lnf": torch.ones(cfg.d_model, dtype=torch.float32, device=device),
        "layers": [_layer_init(cfg, generator, device)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = _normal((cfg.d_model, cfg.vocab_size),
                                 cfg.d_model ** -0.5, cfg, generator, device)
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


def gpt_forward(params: Dict, tokens: torch.Tensor,
                cfg: GPTConfig) -> torch.Tensor:
    """tokens [batch, seq] int -> logits [batch, seq, vocab] (fp32)."""
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = _block(x, layer, cfg)
    x = rms_norm(x, params["lnf"])
    return (x @ _head(params)).float()
