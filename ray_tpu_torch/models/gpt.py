"""Flagship model: decoder-only transformer (GPT family).

Counterpart of ``ray_tpu/models/gpt.py``: the same config fields and
presets, the same param dict (keys, shapes, init scales), so weights
converted from the JAX package load as they are. Matmuls run in the
model dtype, norms and softmax in f32, attention through
``ops.flash_attention`` (the Hopper kernel on CUDA).

``gpt_loss`` is the chunked next-token cross entropy and
``make_train_step`` the AdamW train step over it (``models/_training.py``).
``remat`` checkpoints each block under JAX's policy,
``parallel.ops.dots_with_no_batch_dims_saveable``: the block's products
are kept, the rest of its activations recomputed in the backward.

Tensor parallelism (``tp_axis``, a bound mesh axis; what XLA makes of
``tp_rules`` in the JAX package) is Megatron's: ``wqkv`` and ``w1`` are
split by columns (``wqkv`` head-aligned: each rank holds the q, k and v
columns of its heads, ``TP_SEGMENTS``), ``wo`` and ``w2`` by rows, each
pair joined by an identity-forward / all-reduce-backward ("f") and an
all-reduce-forward / identity-backward ("g"); the tied embedding is split
by vocab rows, its lookup summed over the ranks, and the cross entropy
runs on each rank's vocab columns with the max, the sum of exponentials
and the target's logit combined over ``tp``. The loss and every
gradient are the unsplit model's.

While tracing records (``util.tracing``), the loss from the head's input
to the scalar is the device range ``model.loss`` and ``gpt_forward``'s
head with its f32 cast ``model.head``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import gelu, rms_norm, rope
from ..parallel.ops import (allgather, dots_with_no_batch_dims_saveable,
                            grad_allreduce, saveable_matmul)
from ..util import tracing
from ._init import normal
from ._megatron import embed_tokens, log_likelihood_sum, vocab_offset
from ._training import (gather_params, make_train_step_for, place_params,
                        split_model_axes)

# wqkv's columns are [q | k | v]: a tp split takes each rank's heads of
# each of the three (param key -> (dim, parts)).
TP_SEGMENTS = {"wqkv": (1, 3)}
# Megatron's layout: the dims tp splits, by param (the rest replicated).
TP_LAYOUT = {"wqkv": {"tp": (1,)}, "wo": {"tp": (0,)}, "w1": {"tp": (1,)},
             "w2": {"tp": (0,)}, "embed": {"tp": (0,)}, "head": {"tp": (1,)}}


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


def gpt_param_axes(cfg: GPTConfig) -> Dict:
    """Logical axis names per parameter (parallel.partition rule input),
    the JAX package's table."""
    layer = {
        "ln1": ("embed",),
        "wqkv": ("embed", "mlp"),   # heads concat: shard like mlp over tp
        "wo": ("mlp", "embed"),
        "ln2": ("embed",),
        "w1": ("embed", "mlp"),
        "w2": ("mlp", "embed"),
    }
    axes = {
        "embed": ("vocab", "embed"),
        "lnf": ("embed",),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _block(x: torch.Tensor, layer: Dict, cfg: GPTConfig,
           tp: Optional[str] = None) -> torch.Tensor:
    """One block. With ``tp``, ``layer`` holds this rank's blocks: its
    heads (n_heads / tp of them) and its d_ff / tp hidden units."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    # Attention
    y = rms_norm(x, layer["ln1"])
    if tp is not None:
        y = grad_allreduce(y, tp)
    width = layer["wqkv"].shape[-1] // 3
    h = width // hd
    q, k, v = saveable_matmul(y, layer["wqkv"]).split(width, dim=-1)
    q = rope(q.reshape(b, s, h, hd).transpose(1, 2))
    k = rope(k.reshape(b, s, h, hd).transpose(1, 2))
    v = v.reshape(b, s, h, hd).transpose(1, 2).contiguous()
    attn = flash_attention(q, k, v, True, None)
    attn = attn.transpose(1, 2).reshape(b, s, width)
    x = x + saveable_matmul(attn, layer["wo"], tp)
    # MLP
    y = rms_norm(x, layer["ln2"])
    if tp is not None:
        y = grad_allreduce(y, tp)
    hidden = gelu(saveable_matmul(y, layer["w1"]))
    return x + saveable_matmul(hidden, layer["w2"], tp)


def _head(params: Dict) -> torch.Tensor:
    head = params.get("head")
    return params["embed"].T if head is None else head


def _embed(params: Dict, tokens: torch.Tensor,
           tp: Optional[str]) -> torch.Tensor:
    if tp is None:
        return params["embed"][tokens]
    return embed_tokens(params["embed"], tokens, tp)


def _backbone(params: Dict, tokens: torch.Tensor, cfg: GPTConfig,
              tp: Optional[str] = None) -> torch.Tensor:
    """Embedding + blocks + final norm: [b, s] -> [b, s, d]."""
    x = _embed(params, tokens, tp)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            # JAX's policy: the block's products (and, under tp, the
            # row-parallel sums) are kept; the backward recomputes the
            # norms, rope, gelu and the attention from them.
            x = checkpoint(_block, x, layer, cfg, tp, use_reentrant=False,
                           context_fn=dots_with_no_batch_dims_saveable)
        else:
            x = _block(x, layer, cfg, tp)
    return rms_norm(x, params["lnf"])


def gpt_forward(params: Dict, tokens: torch.Tensor, cfg: GPTConfig,
                tp_axis: Optional[str] = None) -> torch.Tensor:
    """tokens [batch, seq] int -> logits [batch, seq, vocab] (fp32).
    With ``tp_axis``, ``params`` are this rank's tp blocks and every rank
    gets all the logits."""
    x = _backbone(params, tokens, cfg, tp_axis)
    if tp_axis is None:
        if tracing.profiler._is_profiler_enabled:
            return tracing.device_range("model.head", _logits, x,
                                        _head(params))
        return _logits(x, _head(params))
    x = grad_allreduce(x, tp_axis)
    return allgather(_logits(x, _head(params)), tp_axis, axis=-1)


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    return (x @ head).float()


_LOSS_CHUNK = 4096


def gpt_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
             cfg: GPTConfig, tp_axis: Optional[str] = None) -> torch.Tensor:
    """Next-token cross entropy; batch = (tokens, targets) [b, s].

    Chunked over rows as the JAX package does: the largest power of two
    up to ``_LOSS_CHUNK`` that divides the rows, each chunk's [chunk,
    vocab] logits in f32, the log-likelihoods summed in f32. A row count
    with no such divisor above 1 takes the unchunked form. With
    ``tp_axis`` each rank holds a block of the vocab: the logits' max,
    sum of exponentials and target logit are combined over the axis."""
    tokens, targets = batch
    x = _backbone(params, tokens, cfg, tp_axis)
    if tracing.profiler._is_profiler_enabled:
        return tracing.device_range("model.loss", _head_loss, x, params,
                                    targets, tp_axis)
    return _head_loss(x, params, targets, tp_axis)


def _head_loss(x: torch.Tensor, params: Dict, targets: torch.Tensor,
               tp_axis: Optional[str]) -> torch.Tensor:
    """The loss from the backbone's output ``x``: the head's products and
    the cross entropy, chunked (see ``gpt_loss``)."""
    head = _head(params)
    xf = x.reshape(-1, x.shape[-1])
    tf = targets.reshape(-1).long()
    rows = xf.shape[0]
    chunk = _LOSS_CHUNK
    while chunk > 1 and rows % chunk:
        chunk //= 2
    if tp_axis is None and chunk <= 1:
        logits = (xf @ head).float()
        ll = F.log_softmax(logits, dim=-1).gather(1, tf[:, None])[:, 0]
        return -ll.mean()
    chunk = max(chunk, 1)
    if tp_axis is not None:
        xf = grad_allreduce(xf, tp_axis)
        lo = vocab_offset(params["embed"].shape[0], tp_axis)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, rows, chunk):
        lg = (xf[start:start + chunk] @ head).float()
        ts = tf[start:start + chunk]
        if tp_axis is None:
            tgt = lg.gather(1, ts[:, None])[:, 0]
            total = total + (tgt - torch.logsumexp(lg, dim=-1)).sum()
            continue
        total = total + log_likelihood_sum(lg, ts, tp_axis, lo)
    return -total / rows


# ---------------------------------------------------------------------------
# training step
# ---------------------------------------------------------------------------
def make_train_step(cfg: GPTConfig, optimizer=None,
                    device: DeviceLike = None, mesh=None, rules=None):
    """Build (init_state, train_step) for ``cfg`` on ``device`` (None: the
    CUDA card; raises without one). ``optimizer`` maps the list of params
    to a ``torch.optim.Optimizer`` (default: AdamW as the JAX package's
    ``optax.adamw(3e-4, weight_decay=0.01)``). With ``mesh`` and
    ``rules`` (``tp_rules``, ``fsdp_rules``, ``dcn_rules``), the step on
    the mesh: feed it ``shard_batch`` of the global batch;
    ``gather_gpt_params(state["params"], cfg, mesh, rules)`` gives them
    whole. See ``_training.make_train_step_for``."""
    device = resolve_device(device)
    tp = "tp" if split_model_axes("GPT", gpt_param_axes(cfg), mesh, rules,
                                  TP_LAYOUT, cfg.n_heads) else None
    return make_train_step_for(
        lambda generator: gpt_init(cfg, generator, device),
        lambda params, batch: gpt_loss(params, batch, cfg, tp),
        optimizer=optimizer, device=device, axes=gpt_param_axes(cfg),
        mesh=mesh, rules=rules, model_axes=("tp",) if tp else (),
        segments=TP_SEGMENTS)


def shard_params(params: Dict, cfg: GPTConfig, mesh, rules) -> Dict:
    """Place a param tree onto a mesh per the logical-axis rule table:
    this rank's blocks (``wqkv`` head-aligned)."""
    return place_params(params, gpt_param_axes(cfg), mesh, rules,
                        TP_SEGMENTS)


def gather_gpt_params(params: Dict, cfg: GPTConfig, mesh, rules) -> Dict:
    """The inverse of ``shard_params``: every param whole, in the JAX
    layout, on every rank."""
    return gather_params(params, gpt_param_axes(cfg), mesh, rules,
                         TP_SEGMENTS)


def shard_batch(batch, mesh, axis=None):
    """This rank's rows (dim 0) of each array of a global batch: its block
    at its coordinate on ``axis`` (a mesh axis or a tuple of them), as
    the JAX package's ``shard_batch`` shards them (a tuple of numpy
    arrays or tensors in, the same out). ``axis=None`` splits over every
    batch axis of the mesh (``dp_dcn``, ``dp`` and ``fsdp``), where JAX's
    default is ``"dp"``: fsdp and slice ranks then hold rows of their
    own instead of repeating the same ones."""
    from ..parallel.ops import axis_coordinate
    from ._training import BATCH_AXES

    names = mesh.mesh_dim_names or ()
    if axis is None:
        axis = tuple(a for a in BATCH_AXES if a in names)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    axes = tuple(a for a in axes if a in names)
    if not axes:
        return batch
    coord, n = axis_coordinate(mesh, axes)

    def part(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {axes}={n}")
        rows = x.shape[0] // n
        return x[coord * rows:(coord + 1) * rows]

    return type(batch)(part(x) for x in batch)
