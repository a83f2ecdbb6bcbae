"""Llama-family decoder: grouped-query attention + SwiGLU.

Counterpart of ``ray_tpu/models/llama.py``: the same config fields and
presets and the same param dict (keys, shapes, init scales), so weights
converted from the JAX package load as they are. Differences from
``models.gpt``: separate q and kv projections with ``n_kv_heads <
n_heads`` (GQA), a SwiGLU MLP, an untied head and an unchunked loss.
Matmuls run in the model dtype, norms and softmax in f32, attention
through ``ops.flash_attention`` (the Hopper kernels on CUDA).

Tensor parallelism (``tp_axis``, a bound mesh axis; what XLA makes of
``tp_rules`` in the JAX package) is Megatron's, as in ``models.gpt``:
``wq``, ``w_gate`` and ``w_up`` split by columns (``wq`` by whole q
heads), ``wo`` and ``w_down`` by rows, each pair joined by an "f" and a
"g"; ``wkv`` split head-aligned (``TP_SEGMENTS``: each rank holds the k
and v columns of its kv heads, the ones its q heads read, q head h
reading kv head ``h // group_size``). Where ``tp`` exceeds the kv heads
(or does not divide them) a rank's kv head is shared: ``wkv`` is
gathered over ``tp`` in the forward (its gradient reduce-scattered back)
and each rank takes the kv heads its q heads read. The embedding is
split by vocab rows and the head by vocab columns, and the unchunked
cross entropy combines each rank's max, sum of exponentials and target
logit over ``tp``. The loss and every gradient are the unsplit model's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import rms_norm, rope, swiglu
from ..parallel.ops import (allgather, allreduce, axis_index, axis_size,
                            grad_allreduce, remat_context)
from ._init import normal
from ._megatron import embed_tokens, log_likelihood_sum, vocab_offset
from ._training import _unblock, make_train_step_for, split_model_axes

# wkv's columns are [k | v]: a tp split takes each rank's kv heads of
# both (param key -> (dim, parts)).
TP_SEGMENTS = {"wkv": (1, 2)}
# Megatron's layout: the dims tp splits, by param (the rest replicated).
TP_LAYOUT = {"wq": {"tp": (1,)}, "wkv": {"tp": (1,)}, "wo": {"tp": (0,)},
             "w_gate": {"tp": (1,)}, "w_up": {"tp": (1,)},
             "w_down": {"tp": (0,)}, "embed": {"tp": (0,)},
             "head": {"tp": (1,)}}


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


def llama_param_axes(cfg: LlamaConfig) -> Dict:
    layer = {
        "ln1": ("embed",),
        "wq": ("embed", "mlp"),
        "wkv": ("embed", "mlp"),
        "wo": ("mlp", "embed"),
        "ln2": ("embed",),
        "w_gate": ("embed", "mlp"),
        "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed"),
    }
    return {
        "embed": ("vocab", "embed"),
        "lnf": ("embed",),
        "head": ("embed", "vocab"),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _kv(y: torch.Tensor, wkv: torch.Tensor, cfg: LlamaConfig, h: int,
        tp: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v [b, h, s, hd] for this rank's ``h`` q heads: each kv head
    after rope, repeated for every q head of its group."""
    b, s, _ = y.shape
    hd, kvh, g = cfg.head_dim, cfg.n_kv_heads, cfg.group_size
    if tp is None or wkv.shape[-1] // (2 * hd) * g == h:
        # This rank's block holds exactly the kv heads its q heads read.
        kvh_local = wkv.shape[-1] // (2 * hd)
        k, v = (y @ wkv).split(kvh_local * hd, dim=-1)
        k = rope(k.reshape(b, s, kvh_local, hd).transpose(1, 2),
                 base=cfg.rope_base)
        v = v.reshape(b, s, kvh_local, hd).transpose(1, 2)
        # GQA: each kv head repeated group_size times in a row, as
        # jnp.repeat(axis=1) does (a tile would pair other heads). The
        # kernels take q, k, v of one shape, and repeat_interleave itself
        # materializes the expanded k and v as new contiguous tensors;
        # their gradients sum back over each group.
        return (k.repeat_interleave(g, dim=1),
                v.repeat_interleave(g, dim=1))
    # Shared kv heads: wkv whole (gathered over tp, its gradient
    # reduce-scattered back), then the kv heads this rank's q heads read.
    full = _unblock(allgather(wkv, tp, axis=1), 1, axis_size(tp), 2)
    first = axis_index(tp) * h
    lo, hi = first // g, (first + h - 1) // g
    cols = slice(lo * hd, (hi + 1) * hd)
    w = torch.cat([full[:, :kvh * hd][:, cols], full[:, kvh * hd:][:, cols]],
                  dim=-1)
    n = hi - lo + 1
    k, v = (y @ w).split(n * hd, dim=-1)
    k = rope(k.reshape(b, s, n, hd).transpose(1, 2), base=cfg.rope_base)
    v = v.reshape(b, s, n, hd).transpose(1, 2)
    index = torch.tensor([(first + j) // g - lo for j in range(h)],
                         device=y.device)
    return (k.index_select(1, index).contiguous(),
            v.index_select(1, index).contiguous())


def _block(x: torch.Tensor, layer: Dict, cfg: LlamaConfig,
           tp: Optional[str] = None) -> torch.Tensor:
    """One block. With ``tp``, ``layer`` holds this rank's blocks: its
    q heads (n_heads / tp of them), its kv heads' columns of ``wkv`` and
    its d_ff / tp hidden units."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    y = rms_norm(x, layer["ln1"])
    if tp is not None:
        y = grad_allreduce(y, tp)
    q = y @ layer["wq"]
    h = q.shape[-1] // hd
    q = rope(q.reshape(b, s, h, hd).transpose(1, 2), base=cfg.rope_base)
    k, v = _kv(y, layer["wkv"], cfg, h, tp)
    attn = flash_attention(q, k, v, True, None)
    attn = attn.transpose(1, 2).reshape(b, s, h * hd)
    out = attn @ layer["wo"]
    if tp is not None:
        out = allreduce(out, tp)
    x = x + out
    y = rms_norm(x, layer["ln2"])
    if tp is not None:
        y = grad_allreduce(y, tp)
    out = swiglu(y, layer["w_gate"], layer["w_up"], layer["w_down"])
    if tp is not None:
        out = allreduce(out, tp)
    return x + out


def _backbone(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
              tp: Optional[str] = None) -> torch.Tensor:
    """Embedding + blocks + final norm: [b, s] -> [b, s, d]."""
    if tp is None:
        x = params["embed"][tokens]
    else:
        x = embed_tokens(params["embed"], tokens, tp)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            # JAX's policy here is nothing_saveable: keep the block's
            # input only and recompute the block in the backward, which
            # is what torch's checkpoint does.
            x = checkpoint(_block, x, layer, cfg, tp, use_reentrant=False,
                           context_fn=remat_context)
        else:
            x = _block(x, layer, cfg, tp)
    return rms_norm(x, params["lnf"])


def llama_forward(params: Dict, tokens: torch.Tensor,
                  cfg: LlamaConfig) -> torch.Tensor:
    """tokens [batch, seq] int -> logits [batch, seq, vocab] (fp32)."""
    return (_backbone(params, tokens, cfg) @ params["head"]).float()


def llama_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
               cfg: LlamaConfig, tp_axis: Optional[str] = None
               ) -> torch.Tensor:
    """Next-token cross entropy over the full f32 logits (the JAX
    package does not chunk it); batch = (tokens, targets) [b, s]. With
    ``tp_axis`` each rank holds a block of the vocab: the logits' max,
    sum of exponentials and target logit are combined over the axis."""
    tokens, targets = batch
    if tp_axis is None:
        logp = F.log_softmax(llama_forward(params, tokens, cfg), dim=-1)
        ll = logp.gather(-1, targets.long()[..., None])[..., 0]
        return -ll.mean()
    x = _backbone(params, tokens, cfg, tp_axis)
    xf = grad_allreduce(x.reshape(-1, x.shape[-1]), tp_axis)
    head = params["head"]
    logits = (xf @ head).float()
    ll = log_likelihood_sum(logits, targets.reshape(-1).long(), tp_axis,
                            vocab_offset(head.shape[1], tp_axis))
    return -ll / xf.shape[0]


def make_llama_train_step(cfg: LlamaConfig, optimizer=None,
                          device: DeviceLike = None, mesh=None, rules=None):
    """(init_state, train_step) for ``cfg`` on ``device`` (None: the CUDA
    card); the contract of ``models.gpt.make_train_step``, tensor
    parallelism included. ``gather_params(state["params"],
    llama_param_axes(cfg), mesh, rules, TP_SEGMENTS)`` gives the params
    whole."""
    device = resolve_device(device)
    tp = "tp" if split_model_axes("llama", llama_param_axes(cfg), mesh,
                                  rules, TP_LAYOUT, cfg.n_heads) else None
    return make_train_step_for(
        lambda generator: llama_init(cfg, generator, device),
        lambda params, batch: llama_loss(params, batch, cfg, tp),
        optimizer=optimizer, device=device, axes=llama_param_axes(cfg),
        mesh=mesh, rules=rules, model_axes=("tp",) if tp else (),
        segments=TP_SEGMENTS)
