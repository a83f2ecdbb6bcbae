"""Autoregressive generation with a KV cache (GPT family).

Counterpart of ``ray_tpu/models/generate.py``: a fixed-shape KV cache,
rotary offsets per position, f32 attention over the whole cache with the
``DEFAULT_MASK_VALUE`` mask, f32 logits. Attention here is plain PyTorch,
as in the JAX package (einsums over the cache, no flash kernel).

Cache layout: per layer {"k"|"v": [batch, heads, max_len, head_dim]}.

JAX jits these steps and donates the cache, so each call returns a new
cache buffer. PyTorch runs eagerly, so the port writes the new keys and
values into the cache IN PLACE; the step functions still return the
cache so callers read the same as against the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.attention import DEFAULT_MASK_VALUE
from ..ops.layers import rms_norm, rope
from .gpt import GPTConfig, _head

StartPos = Union[int, torch.Tensor]


def init_cache(cfg: GPTConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
    device = resolve_device(device)
    shape = (batch, cfg.n_heads, max_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _cached_block(x: torch.Tensor, layer: Dict, cache_layer: Dict,
                  start_pos: StartPos, cfg: GPTConfig
                  ) -> Tuple[torch.Tensor, Dict]:
    """One transformer block reading/writing the KV cache (in place).

    x: [b, L, d]. ``start_pos`` is the absolute offset of x's positions:
    a scalar (all rows aligned: prefill / single-stream decode) or a [b]
    tensor (continuous batching: every row at its own position). Only the
    cache write and the causal mask specialize on which."""
    b, L, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    k_cache, v_cache = cache_layer["k"], cache_layer["v"]
    max_len = k_cache.shape[-2]
    per_row = torch.is_tensor(start_pos) and start_pos.ndim == 1
    steps = torch.arange(L, device=x.device)

    y = rms_norm(x, layer["ln1"])
    q, k, v = (y @ layer["wqkv"]).split(d, dim=-1)
    q = q.reshape(b, L, h, hd).transpose(1, 2)
    k = k.reshape(b, L, h, hd).transpose(1, 2)
    v = v.reshape(b, L, h, hd).transpose(1, 2)
    if per_row:
        sp = start_pos.to(x.device)
        positions = sp[:, None] + steps[None]            # (b, L)
    else:
        sp = int(start_pos)
        positions = sp + steps                           # (L,)
    q = rope(q, positions=positions)
    k = rope(k, positions=positions)

    if per_row:
        rows = torch.arange(b, device=x.device)[:, None]  # (b, 1)
        # Indices on axes 0 and 2 move to the front: value (b, L, h, hd).
        k_cache[rows, :, positions, :] = k.transpose(1, 2).to(k_cache.dtype)
        v_cache[rows, :, positions, :] = v.transpose(1, 2).to(v_cache.dtype)
    else:
        k_cache[:, :, sp:sp + L] = k.to(k_cache.dtype)
        v_cache[:, :, sp:sp + L] = v.to(v_cache.dtype)

    scale = hd ** -0.5
    s = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * scale
    k_pos = torch.arange(max_len, device=x.device)
    if per_row:
        mask = (k_pos[None, None] <= positions[:, :, None])[:, None]
    else:
        mask = (k_pos[None] <= positions[:, None])[None, None]
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    attn = torch.matmul(p.to(v_cache.dtype), v_cache)
    attn = attn.transpose(1, 2).reshape(b, L, d)
    x = x + attn @ layer["wo"]
    y = rms_norm(x, layer["ln2"])
    x = x + F.gelu(y @ layer["w1"], approximate="tanh") @ layer["w2"]
    return x, cache_layer


def cached_forward(params: Dict, tokens: torch.Tensor, cache: List[Dict],
                   start_pos: StartPos, cfg: GPTConfig
                   ) -> Tuple[torch.Tensor, List[Dict]]:
    """Forward over ``tokens`` [b, L] at absolute offset ``start_pos``,
    writing the cache in place. Returns (logits [b, L, vocab] fp32,
    cache)."""
    x = params["embed"][tokens]
    for layer, cache_layer in zip(params["layers"], cache):
        x, _ = _cached_block(x, layer, cache_layer, start_pos, cfg)
    x = rms_norm(x, params["lnf"])
    return (x @ _head(params)).float(), cache


def make_generate_fns(cfg: GPTConfig, max_len: int):
    """(prefill, decode_step): plain closures that update the cache in
    place (the JAX package jits them and donates the cache; PyTorch runs
    eagerly, so there is nothing to compile or cache). ``max_len`` is
    kept for parity: caches passed in must have this length.

    prefill(params, tokens[b, Lp], cache) -> (last_logits[b, vocab], cache)
    decode_step(params, token[b], pos, cache) -> (logits[b, vocab], cache)
    """

    @torch.inference_mode()
    def prefill(params, tokens, cache):
        logits, cache = cached_forward(params, tokens, cache, 0, cfg)
        return logits[:, -1, :], cache

    @torch.inference_mode()
    def decode_step(params, token, pos, cache):
        logits, cache = cached_forward(params, token[:, None], cache, pos,
                                       cfg)
        return logits[:, 0, :], cache

    return prefill, decode_step


def make_continuous_fns(cfg: GPTConfig, max_len: int, batch: int):
    """(insert_prefill, decode_batch) for continuous batching over one
    shared [batch, ...] cache whose slots belong to independent requests.
    Plain closures that write the cache in place (see make_generate_fns).

    insert_prefill(params, tokens[1, Lp], cache, slot, true_len)
        -> (last_logits[vocab], cache)  # logits at true_len-1; the
        prompt may be right-padded to the Lp bucket, padding positions
        are never read back (decode overwrites position p before any
        read at p).
    decode_batch(params, tokens[B], pos[B], cache)
        -> (logits[B, vocab], cache)
    """

    @torch.inference_mode()
    def insert_prefill(params, tokens, cache, slot: int, true_len: int):
        # A one-row view of each layer's cache: writes land in the slot.
        sub = [{k: cl[k][slot:slot + 1] for k in ("k", "v")} for cl in cache]
        logits, _ = cached_forward(params, tokens, sub, 0, cfg)
        return logits[0, true_len - 1], cache

    @torch.inference_mode()
    def decode_batch(params, tokens, pos, cache):
        # Per-row start_pos: the same block as prefill and single decode.
        logits, cache = cached_forward(params, tokens[:, None], cache, pos,
                                       cfg)
        return logits[:, 0, :], cache

    return insert_prefill, decode_batch


def _bucket_len(n: int, cap: int) -> int:
    """Round up to a power of two (min 64), capped."""
    b = 64
    while b < n:
        b *= 2
    return min(b, cap)


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling; [b, vocab] -> [b]."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params: Dict, cfg: GPTConfig, prompt,
             max_new_tokens: int = 32, temperature: float = 0.0,
             max_len: Optional[int] = None, seed: int = 0,
             stop_token: Optional[int] = None) -> Iterator[torch.Tensor]:
    """Generator yielding one [batch] token tensor per step (so callers can
    stream them). Runs on the device that holds ``params``."""
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, device=device).long()
    if prompt.ndim == 1:
        prompt = prompt[None]
    b, lp = prompt.shape
    total = max_len or _bucket_len(lp + max_new_tokens, cfg.max_seq_len)
    if not lp + max_new_tokens <= total <= cfg.max_seq_len:
        raise ValueError(
            f"prompt ({lp}) + max_new_tokens ({max_new_tokens}) must fit "
            f"in max_len ({total}) <= cfg.max_seq_len "
            f"({cfg.max_seq_len})")
    prefill, decode_step = make_generate_fns(cfg, total)
    with torch.inference_mode():
        cache = init_cache(cfg, b, total, device)
    logits, cache = prefill(params, prompt, cache)
    generator = torch.Generator(device=device).manual_seed(seed)
    pos = lp
    for i in range(max_new_tokens):
        token = sample_token(logits, generator, temperature)
        yield token
        if stop_token is not None and bool((token == stop_token).all()):
            return
        if i + 1 < max_new_tokens:  # last sample needs no next logits
            logits, cache = decode_step(params, token, pos, cache)
            pos += 1
