"""Llama-family decoder: grouped-query attention + SwiGLU.

Counterpart of ``ray_tpu/models/llama.py``: the same config fields and
presets and the same param dict (keys, shapes, init scales), so weights
converted from the JAX package load as they are. Differences from
``models.gpt``: separate q and kv projections with ``n_kv_heads <
n_heads`` (GQA), a SwiGLU MLP, an untied head and an unchunked loss.
Matmuls run in the model dtype, norms and softmax in f32, attention
through ``ops.flash_attention`` (the Hopper kernels on CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import rms_norm, rope, swiglu
from ._init import normal
from ._training import make_train_step_for


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 2
    n_layers: int = 6
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_base: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=512, d_model=64, n_heads=4, n_kv_heads=2,
                   n_layers=2, d_ff=96, max_seq_len=128)

    @classmethod
    def tpu_bench(cls) -> "LlamaConfig":
        """The JAX package's single-chip bench shape: head_dim 128, 4:1
        GQA, S=2048, about 245M params, remat off."""
        return cls(vocab_size=32000, d_model=1024, n_heads=8,
                   n_kv_heads=2, n_layers=16, d_ff=2816,
                   max_seq_len=2048, remat=False)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_init(cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    kv_d = cfg.n_kv_heads * cfg.head_dim
    scale = d ** -0.5
    out_scale = scale / (2 * cfg.n_layers) ** 0.5
    ones = torch.ones(d, dtype=torch.float32, device=device)

    def draw(shape, std):
        return normal(shape, std, cfg.dtype, generator, device)

    return {
        "ln1": ones,
        "wq": draw((d, d), scale),
        "wkv": draw((d, 2 * kv_d), scale),
        "wo": draw((d, d), out_scale),
        "ln2": ones.clone(),
        "w_gate": draw((d, f), scale),
        "w_up": draw((d, f), scale),
        "w_down": draw((f, d), out_scale),
    }


def llama_init(cfg: LlamaConfig, generator: torch.Generator,
               device: DeviceLike = None) -> Dict:
    """Random params with the JAX package's keys, shapes and scales,
    drawn from ``generator`` (see ``gpt_init``)."""
    device = resolve_device(device)
    std = cfg.d_model ** -0.5
    return {
        "embed": normal((cfg.vocab_size, cfg.d_model), std, cfg.dtype,
                        generator, device),
        "lnf": torch.ones(cfg.d_model, dtype=torch.float32, device=device),
        "head": normal((cfg.d_model, cfg.vocab_size), std, cfg.dtype,
                       generator, device),
        "layers": [_layer_init(cfg, generator, device)
                   for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _block(x: torch.Tensor, layer: Dict, cfg: LlamaConfig) -> torch.Tensor:
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    y = rms_norm(x, layer["ln1"])
    q = y @ layer["wq"]
    k, v = (y @ layer["wkv"]).split(kvh * hd, dim=-1)
    q = rope(q.reshape(b, s, h, hd).transpose(1, 2), base=cfg.rope_base)
    k = rope(k.reshape(b, s, kvh, hd).transpose(1, 2), base=cfg.rope_base)
    v = v.reshape(b, s, kvh, hd).transpose(1, 2)
    # GQA: each kv head repeated group_size times in a row, as
    # jnp.repeat(axis=1) does (a tile would pair other heads). The
    # kernels take q, k, v of one shape, and repeat_interleave itself
    # materializes the expanded k and v as new contiguous tensors; their
    # gradients sum back over each group.
    k = k.repeat_interleave(cfg.group_size, dim=1)
    v = v.repeat_interleave(cfg.group_size, dim=1)
    attn = flash_attention(q, k, v, True, None)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + attn @ layer["wo"]
    y = rms_norm(x, layer["ln2"])
    return x + swiglu(y, layer["w_gate"], layer["w_up"], layer["w_down"])


def llama_forward(params: Dict, tokens: torch.Tensor,
                  cfg: LlamaConfig) -> torch.Tensor:
    """tokens [batch, seq] int -> logits [batch, seq, vocab] (fp32)."""
    x = params["embed"][tokens]
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            # JAX's policy here is nothing_saveable: keep the block's
            # input only and recompute the block in the backward, which
            # is what torch's checkpoint does.
            x = checkpoint(_block, x, layer, cfg, use_reentrant=False)
        else:
            x = _block(x, layer, cfg)
    x = rms_norm(x, params["lnf"])
    return (x @ params["head"]).float()


def llama_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
               cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy over the full f32 logits (the JAX
    package does not chunk it); batch = (tokens, targets) [b, s]."""
    tokens, targets = batch
    logp = F.log_softmax(llama_forward(params, tokens, cfg), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def make_llama_train_step(cfg: LlamaConfig, optimizer=None,
                          device: DeviceLike = None):
    """(init_state, train_step) for ``cfg`` on ``device`` (None: the CUDA
    card); the contract of ``models.gpt.make_train_step``."""
    device = resolve_device(device)
    return make_train_step_for(
        lambda generator: llama_init(cfg, generator, device),
        lambda params, batch: llama_loss(params, batch, cfg),
        optimizer=optimizer, device=device)
