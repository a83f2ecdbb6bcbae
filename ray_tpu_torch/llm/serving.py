"""Online LLM serving engine: KV-cache decode streamed token by token.

Counterpart of ``ray_tpu/llm/serving.py``'s ``ByteTokenizer`` and
``LLMEngine``. ``build_llm_app`` (the Serve deployment that hosts the
engine) waits for the port's control plane.

Zero-egress tokenizer: a byte-level vocabulary (ids 0-255 + BOS) so the
engine runs without downloaded vocabularies; swap ``tokenizer=`` for a
real one in production.
"""

from __future__ import annotations

import codecs
from typing import Iterator

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..models.convert import params_to
from ..models.generate import generate
from ..models.gpt import GPTConfig, gpt_init

BOS = 256


class ByteTokenizer:
    """Byte-level tokenizer (vocab 257: bytes + BOS)."""

    vocab_size = 257

    def encode(self, text: str):
        return [BOS] + list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")


def default_engine_config() -> GPTConfig:
    """The engines' model when none is given (as in the JAX package)."""
    return GPTConfig(vocab_size=max(ByteTokenizer.vocab_size, 272),
                     d_model=256, n_heads=8, n_layers=4, d_ff=1024,
                     max_seq_len=512)


class LLMEngine:
    """Prefill + decode wrapper around a GPT-family model (construct once
    per replica; generation streams tokens). Runs on ``device`` (the card
    by default) under ``torch.inference_mode``."""

    def __init__(self, cfg=None, params=None, tokenizer=None,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or ByteTokenizer()
        self.cfg = cfg or default_engine_config()
        if params is None:
            params = gpt_init(self.cfg, torch.Generator().manual_seed(seed),
                              self.device)
        self.params = params_to(params, self.device)

    def stream(self, prompt: str, max_new_tokens: int = 64,
               temperature: float = 0.0) -> Iterator[str]:
        """Yield decoded text fragments token by token. Multi-byte UTF-8
        sequences are buffered across tokens (an incremental decoder), and
        over-long prompts keep their TAIL so the model conditions on the
        most recent context."""
        encoded = self.tokenizer.encode(prompt)
        # Leave room for at least one generated token.
        keep = self.cfg.max_seq_len - max(1, min(max_new_tokens, 16))
        if len(encoded) > keep:
            encoded = encoded[-keep:]
        ids = np.asarray([encoded], np.int64)
        budget = self.cfg.max_seq_len - ids.shape[1]
        decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        for token in generate(self.params, self.cfg, ids,
                              max_new_tokens=min(max_new_tokens, budget),
                              temperature=temperature):
            t = int(token[0])
            piece = decoder.decode(bytes([t])) if 0 <= t < 256 else ""
            if piece:
                yield piece
        tail = decoder.decode(b"", final=True)
        if tail:
            yield tail

    def complete(self, prompt: str, max_new_tokens: int = 64,
                 temperature: float = 0.0) -> str:
        return "".join(self.stream(prompt, max_new_tokens, temperature))
