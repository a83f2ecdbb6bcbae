"""Batch pipeline stages: tokenize -> generate -> detokenize.

Counterpart of ``ray_tpu/llm/batch.py``'s ``TokenizeStage``,
``DetokenizeStage`` and ``GPTInferenceStage``. Every stage is a callable
over columnar dict batches. ``Processor`` (which chains them over a
Dataset), the chat template and the HTTP stage wait for the port's
control plane.

``GPTInferenceStage`` is the serving path that runs the flash kernel:
every greedy step runs the full ``gpt_forward`` over the padded bucket,
so each layer launches the attention kernel once per step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..models.convert import params_to
from ..models.gpt import GPTConfig, gpt_forward, gpt_init


class TokenizeStage:
    """Prompt -> token ids, with a built-in byte tokenizer (no downloads;
    the JAX package's Hugging Face tokenizer option waits)."""

    def __init__(self, input_column: str = "prompt",
                 output_column: str = "tokens", max_length: int = 512):
        self._in, self._out = input_column, output_column
        self._max = max_length

    def _encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))[: self._max]

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(batch)
        out[self._out] = [np.asarray(self._encode(p), np.int32)
                          for p in batch[self._in]]
        return out


class DetokenizeStage:
    """Token ids -> text (byte tokenizer)."""

    def __init__(self, input_column: str = "generated_tokens",
                 output_column: str = "generated_text"):
        self._in, self._out = input_column, output_column

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        texts = []
        for toks in batch[self._in]:
            texts.append(bytes(int(t) % 256 for t in toks).decode(
                "utf-8", errors="replace"))
        out = dict(batch)
        out[self._out] = texts
        return out


class GPTInferenceStage:
    """Greedy decode with the in-repo GPT: prompts are left-padded with
    zeros (no pad mask) to a power-of-two bucket, and each step runs the
    full forward over the bucket and slides the window by one token
    (``toks[:, 1:] ++ next``), as the JAX stage does."""

    def __init__(self, config: Optional[GPTConfig] = None, params=None,
                 max_new_tokens: int = 8, input_column: str = "tokens",
                 output_column: str = "generated_tokens",
                 device: DeviceLike = None):
        self._device = resolve_device(device)
        self._cfg = config or GPTConfig.tiny()
        if params is None:
            params = gpt_init(self._cfg, torch.Generator().manual_seed(0),
                              self._device)
        self._params = params_to(params, self._device)
        self._max_new = max_new_tokens
        self._in, self._out = input_column, output_column

    @torch.inference_mode()
    def _decode(self, tokens: torch.Tensor) -> torch.Tensor:
        news = []
        for _ in range(self._max_new):
            logits = gpt_forward(self._params, tokens, self._cfg)
            nxt = logits[:, -1, :].argmax(dim=-1)
            tokens = torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)
            news.append(nxt)
        return torch.stack(news, dim=1)  # [B, max_new]

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        toks_list = batch[self._in]
        vocab = self._cfg.vocab_size
        max_len = min(self._bucket(max(len(t) for t in toks_list)),
                      self._cfg.max_seq_len)
        padded = np.zeros((len(toks_list), max_len), np.int64)
        for i, t in enumerate(toks_list):
            t = np.asarray(t)[-max_len:] % vocab
            padded[i, max_len - len(t):] = t  # left-pad (decode reads tail)
        news = self._decode(torch.from_numpy(padded).to(self._device))
        news = news.cpu().numpy().astype(np.int32)
        out = dict(batch)
        out[self._out] = [news[i] for i in range(len(toks_list))]
        return out
