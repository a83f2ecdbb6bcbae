"""Mixture-of-Experts decoder (Mixtral-style).

Counterpart of ``ray_tpu/models/moe.py``: a GPT-family decoder whose MLP
is the top-2 routed expert layer ``parallel.moe.moe_layer``, with the
same config fields and param dict. The router ``gate`` stays f32 whatever
the model dtype (a flip reroutes a whole token); attention is causal
through ``ops.flash_attention`` (the Hopper kernels on CUDA); the head is
tied to the embedding. Only the single-device dense dispatch is ported:
a config with ``ep_axis`` set raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import rms_norm, rope
from ..parallel.moe import moe_layer
from ._init import normal
from ._training import make_train_step_for


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    n_experts: int = 8
    d_ff: int = 1024
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # Mesh axis for expert parallelism in the JAX package; carried, but
    # only None (the single-device dense dispatch) is ported.
    ep_axis: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.ep_axis is not None:
            raise NotImplementedError(
                f"MoEConfig(ep_axis={self.ep_axis!r}): expert parallelism "
                "belongs to the port's parallel-strategies slice "
                "(ROADMAP.md, Queue 1) and is not ported yet")

    @classmethod
    def tiny(cls) -> "MoEConfig":
        return cls(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                   n_experts=4, d_ff=96, max_seq_len=64)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_init(cfg: MoEConfig, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = d ** -0.5
    out_scale = scale / (2 * cfg.n_layers) ** 0.5
    ones = torch.ones(d, dtype=torch.float32, device=device)

    def draw(shape, std, dtype=cfg.dtype):
        return normal(shape, std, dtype, generator, device)

    return {
        "ln1": ones,
        "wqkv": draw((d, 3 * d), scale),
        "wo": draw((d, d), out_scale),
        "ln2": ones.clone(),
        "gate": draw((d, e), scale, torch.float32),
        "expert_w1": draw((e, d, f), scale),
        "expert_w2": draw((e, f, d), out_scale),
    }


def moe_init(cfg: MoEConfig, generator: torch.Generator,
             device: DeviceLike = None) -> Dict:
    """Random params with the JAX package's keys, shapes and scales,
    drawn from ``generator`` (see ``gpt_init``)."""
    device = resolve_device(device)
    return {
        "embed": normal((cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5,
                        cfg.dtype, generator, device),
        "lnf": torch.ones(cfg.d_model, dtype=torch.float32, device=device),
        "layers": [_layer_init(cfg, generator, device)
                   for _ in range(cfg.n_layers)],
    }


def moe_param_axes(cfg: MoEConfig) -> Dict:
    layer = {
        "ln1": ("embed",),
        "wqkv": ("embed", "mlp"),
        "wo": ("mlp", "embed"),
        "ln2": ("embed",),
        "gate": ("embed", None),
        "expert_w1": ("expert", "embed", "mlp"),
        "expert_w2": ("expert", "mlp", "embed"),
    }
    return {
        "embed": ("vocab", "embed"),
        "lnf": ("embed",),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _block(x: torch.Tensor, layer: Dict, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    y = rms_norm(x, layer["ln1"])
    q, k, v = (y @ layer["wqkv"]).split(d, dim=-1)
    q = rope(q.reshape(b, s, h, hd).transpose(1, 2))
    k = rope(k.reshape(b, s, h, hd).transpose(1, 2))
    v = v.reshape(b, s, h, hd).transpose(1, 2).contiguous()
    attn = flash_attention(q, k, v, True, None)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + attn @ layer["wo"]
    # Routed expert MLP over the flattened tokens.
    y = rms_norm(x, layer["ln2"])
    out, aux = moe_layer(y.reshape(b * s, d), layer["gate"],
                         layer["expert_w1"], layer["expert_w2"],
                         capacity_factor=cfg.capacity_factor,
                         axis_name=cfg.ep_axis)
    return x + out.reshape(b, s, d), aux


def moe_forward(params: Dict, tokens: torch.Tensor, cfg: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] -> (logits [b, s, vocab] fp32, aux_loss averaged
    over the layers)."""
    x = params["embed"][tokens]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            # JAX's policy here is nothing_saveable: keep the block's
            # input only and recompute the block in the backward, which
            # is what torch's checkpoint does.
            x, aux = checkpoint(_block, x, layer, cfg, use_reentrant=False)
        else:
            x, aux = _block(x, layer, cfg)
        aux_total = aux_total + aux
    x = rms_norm(x, params["lnf"])
    logits = (x @ params["embed"].T).float()
    return logits, aux_total / len(params["layers"])


def moe_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
             cfg: MoEConfig) -> torch.Tensor:
    """Next-token cross entropy plus ``aux_loss_weight`` times the
    load-balancing loss; batch = (tokens, targets) [b, s]."""
    tokens, targets = batch
    logits, aux = moe_forward(params, tokens, cfg)
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -ll.mean() + cfg.aux_loss_weight * aux


def make_moe_train_step(cfg: MoEConfig, optimizer=None,
                        device: DeviceLike = None, mesh=None, rules=None):
    """(init_state, train_step) for ``cfg`` on ``device`` (None: the CUDA
    card); the contract of ``models.gpt.make_train_step``."""
    device = resolve_device(device)
    return make_train_step_for(
        lambda generator: moe_init(cfg, generator, device),
        lambda params, batch: moe_loss(params, batch, cfg),
        optimizer=optimizer, device=device, axes=moe_param_axes(cfg),
        mesh=mesh, rules=rules)
