"""Mixture-of-Experts decoder (Mixtral-style).

Counterpart of ``ray_tpu/models/moe.py``: a GPT-family decoder whose MLP
is the top-2 routed expert layer ``parallel.moe.moe_layer``, with the
same config fields and param dict. The router ``gate`` stays f32 whatever
the model dtype (a flip reroutes a whole token); attention is causal
through ``ops.flash_attention`` (the Hopper kernels on CUDA); the head is
tied to the embedding. With ``ep_axis`` set, ``moe_forward`` and
``moe_loss`` run inside ``parallel.ops.shard_map`` with the expert
weights split over that axis: each layer's tokens go to their experts'
ranks by all-to-all (``parallel.moe.moe_layer``).

The train step on a mesh (``split``, a ``MoESplit`` of bound mesh axes;
what XLA makes of the JAX step's sharded params) runs
``parallel.moe.moe_layer_split`` instead: the tokens of every batch
shard routed as one batch, attention in Megatron's form over ``tp`` as
in ``models.gpt`` (``wqkv`` head-aligned, ``wo`` by rows, the tied
embedding by vocab rows and the cross entropy on each rank's vocab
columns), each expert's d_ff split over ``tp`` and the experts over
``ep``, the tokens replicated over both; the router ``gate`` is
replicated. The loss and every gradient are the unsplit model's.
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
from ..parallel.moe import moe_layer, moe_layer_split
from ..parallel.ops import allreduce, grad_allreduce, remat_context
from ._init import normal
from ._megatron import embed_tokens, log_likelihood_sum, vocab_offset
from ._training import batch_axes_of, make_train_step_for, split_model_axes

# wqkv's columns are [q | k | v]: a tp split takes each rank's heads of
# each of the three (param key -> (dim, parts)).
TP_SEGMENTS = {"wqkv": (1, 3)}
# The axes the step's model code splits, and the dims each splits by
# param (the rest replicated): Megatron's attention and experts over tp,
# the experts over ep.
MODEL_AXES = ("tp", "ep")
LAYOUT = {"wqkv": {"tp": (1,)}, "wo": {"tp": (0,)},
          "expert_w1": {"ep": (0,), "tp": (2,)},
          "expert_w2": {"ep": (0,), "tp": (1,)}, "embed": {"tp": (0,)}}


@dataclasses.dataclass(frozen=True)
class MoESplit:
    """The mesh axes the train step splits the MoE decoder over, each
    bound by ``parallel.ops.bind``: ``tp`` (attention's heads, each
    expert's d_ff, the vocab), ``ep`` (the experts; the tokens are
    replicated over it) and ``tokens`` (the batch axes the rows are split
    over, routed as one batch)."""

    tp: Optional[str] = None
    ep: Optional[str] = None
    tokens: Tuple[str, ...] = ()


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
    # Mesh axis name for expert parallelism (used inside shard_map);
    # None = the single-shard dense dispatch.
    ep_axis: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

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
def _block(x: torch.Tensor, layer: Dict, cfg: MoEConfig,
           split: Optional[MoESplit] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block. With ``split``, ``layer`` holds this rank's blocks."""
    b, s, d = x.shape
    hd = cfg.head_dim
    tp = split.tp if split is not None else None
    y = rms_norm(x, layer["ln1"])
    if tp is not None:
        y = grad_allreduce(y, tp)
    width = layer["wqkv"].shape[-1] // 3
    h = width // hd
    q, k, v = (y @ layer["wqkv"]).split(width, dim=-1)
    q = rope(q.reshape(b, s, h, hd).transpose(1, 2))
    k = rope(k.reshape(b, s, h, hd).transpose(1, 2))
    v = v.reshape(b, s, h, hd).transpose(1, 2).contiguous()
    attn = flash_attention(q, k, v, True, None)
    attn = attn.transpose(1, 2).reshape(b, s, width)
    out = attn @ layer["wo"]
    if tp is not None:
        out = allreduce(out, tp)
    x = x + out
    # Routed expert MLP over the flattened tokens.
    y = rms_norm(x, layer["ln2"])
    if split is None:
        out, aux = moe_layer(y.reshape(b * s, d), layer["gate"],
                             layer["expert_w1"], layer["expert_w2"],
                             capacity_factor=cfg.capacity_factor,
                             axis_name=cfg.ep_axis)
    else:
        out, aux = moe_layer_split(
            y.reshape(b * s, d), layer["gate"], layer["expert_w1"],
            layer["expert_w2"], cfg.capacity_factor, tp=split.tp,
            ep=split.ep, token_axes=split.tokens)
    return x + out.reshape(b, s, d), aux


def _backbone(params: Dict, tokens: torch.Tensor, cfg: MoEConfig,
              split: Optional[MoESplit] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedding + blocks + final norm: [b, s] -> ([b, s, d], aux_loss
    averaged over the layers)."""
    tp = split.tp if split is not None else None
    if tp is None:
        x = params["embed"][tokens]
    else:
        x = embed_tokens(params["embed"], tokens, tp)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            # JAX's policy here is nothing_saveable: keep the block's
            # input only and recompute the block in the backward, which
            # is what torch's checkpoint does.
            x, aux = checkpoint(_block, x, layer, cfg, split,
                                use_reentrant=False,
                                context_fn=remat_context)
        else:
            x, aux = _block(x, layer, cfg, split)
        aux_total = aux_total + aux
    return rms_norm(x, params["lnf"]), aux_total / len(params["layers"])


def moe_forward(params: Dict, tokens: torch.Tensor, cfg: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] -> (logits [b, s, vocab] fp32, aux_loss averaged
    over the layers)."""
    x, aux = _backbone(params, tokens, cfg)
    return (x @ params["embed"].T).float(), aux


def moe_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
             cfg: MoEConfig, split: Optional[MoESplit] = None
             ) -> torch.Tensor:
    """Next-token cross entropy plus ``aux_loss_weight`` times the
    load-balancing loss; batch = (tokens, targets) [b, s]. With
    ``split.tp`` each rank holds a block of the vocab: the logits' max,
    sum of exponentials and target logit are combined over the axis."""
    tokens, targets = batch
    x, aux = _backbone(params, tokens, cfg, split)
    embed = params["embed"]
    if split is None or split.tp is None:
        logp = F.log_softmax((x @ embed.T).float(), dim=-1)
        ll = logp.gather(-1, targets.long()[..., None])[..., 0]
        ce = -ll.mean()
    else:
        xf = grad_allreduce(x.reshape(-1, x.shape[-1]), split.tp)
        ce = -log_likelihood_sum(
            (xf @ embed.T).float(), targets.reshape(-1).long(), split.tp,
            vocab_offset(embed.shape[0], split.tp)) / xf.shape[0]
    if cfg.ep_axis is not None:
        # aux is the same on every rank of the axis and enters this rank's
        # own loss: its gradient is summed over the axis (the transpose
        # of JAX's implicit pvary).
        aux = grad_allreduce(aux, cfg.ep_axis)
    return ce + cfg.aux_loss_weight * aux


def _split_for(cfg: MoEConfig, mesh, rules) -> Optional[MoESplit]:
    """The step's MoESplit on ``mesh`` (None off a mesh, or where nothing
    is split), checking that the rules split the params as Megatron's
    layout has it."""
    if mesh is None:
        return None
    if cfg.ep_axis is not None:
        raise ValueError(
            "ep_axis is moe_layer's all-to-all form under shard_map; the "
            "train step takes its expert axis from the mesh and rules")
    used = split_model_axes("MoE", moe_param_axes(cfg), mesh, rules, LAYOUT,
                            cfg.n_heads, MODEL_AXES)
    split = MoESplit(tp="tp" if "tp" in used else None,
                     ep="ep" if "ep" in used else None,
                     tokens=batch_axes_of(mesh))
    return None if split == MoESplit() else split


def make_moe_train_step(cfg: MoEConfig, optimizer=None,
                        device: DeviceLike = None, mesh=None, rules=None):
    """(init_state, train_step) for ``cfg`` on ``device`` (None: the CUDA
    card); the contract of ``models.gpt.make_train_step``, with tensor
    and expert parallelism (``ep`` in the mesh, ``"expert"`` in the
    rules). ``gather_params(state["params"], moe_param_axes(cfg), mesh,
    rules, TP_SEGMENTS)`` gives the params whole."""
    device = resolve_device(device)
    split = _split_for(cfg, mesh, rules)
    return make_train_step_for(
        lambda generator: moe_init(cfg, generator, device),
        lambda params, batch: moe_loss(params, batch, cfg, split),
        optimizer=optimizer, device=device, axes=moe_param_axes(cfg),
        mesh=mesh, rules=rules, model_axes=MODEL_AXES,
        segments=TP_SEGMENTS)
