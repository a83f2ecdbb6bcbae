"""Batch pipeline stages and the Processor that chains them over a Dataset.

Counterpart of ``ray_tpu/llm/batch.py``: ``ChatTemplateStage``,
``TokenizeStage``, ``HttpRequestStage``, ``GPTInferenceStage``,
``DetokenizeStage``, ``ProcessorConfig``, ``StageSpec``, ``Processor`` and
``build_processor``. Every stage is a callable over columnar dict
batches. Stateful stages are callable CLASSES so ``ray_tpu_torch.data``
hosts them in an actor pool and state is built once per actor.

The text stages have the byte tokenizer only: a Hugging Face model id
(``model=``) needs tokenizer files that the repo does not have, so any
``model`` other than ``None`` raises NotImplementedError.

``GPTInferenceStage`` is the serving path that runs the flash kernel:
every greedy step runs the full ``gpt_forward`` over the padded bucket,
so each layer launches the attention kernel once per step. It alone
imports torch, when it is built: a pool actor that hosts a text stage
starts without it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional

import numpy as np

if TYPE_CHECKING:
    from .._device import DeviceLike
    from ..models.gpt import GPTConfig


def _byte_tokenizer_only(model: Optional[str]) -> None:
    if model is not None:
        raise NotImplementedError(
            f"model={model!r}: ray_tpu_torch's text stages have the byte "
            "tokenizer only (model=None); loading a Hugging Face "
            "tokenizer needs files the repo does not have")


class ChatTemplateStage:
    """Render chat messages into a prompt string in a plain role-tagged
    format (messages may be a list of dicts or its JSON string)."""

    def __init__(self, model: Optional[str] = None,
                 input_column: str = "messages",
                 output_column: str = "prompt"):
        _byte_tokenizer_only(model)
        self._in = input_column
        self._out = output_column

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        prompts = []
        for messages in batch[self._in]:
            if isinstance(messages, str):
                messages = json.loads(messages)
            prompts.append("\n".join(
                f"<|{m['role']}|>: {m['content']}" for m in messages
            ) + "\n<|assistant|>:")
        out = dict(batch)
        out[self._out] = prompts
        return out


class TokenizeStage:
    """Prompt -> token ids with the built-in byte tokenizer (no
    downloads)."""

    def __init__(self, model: Optional[str] = None,
                 input_column: str = "prompt",
                 output_column: str = "tokens", max_length: int = 512):
        _byte_tokenizer_only(model)
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

    def __init__(self, model: Optional[str] = None,
                 input_column: str = "generated_tokens",
                 output_column: str = "generated_text"):
        _byte_tokenizer_only(model)
        self._in, self._out = input_column, output_column

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        texts = []
        for toks in batch[self._in]:
            texts.append(bytes(int(t) % 256 for t in toks).decode(
                "utf-8", errors="replace"))
        out = dict(batch)
        out[self._out] = texts
        return out


class HttpRequestStage:
    """POST each row to an endpoint (the hosted-LLM path). Serial per
    batch."""

    def __init__(self, url: str, payload_column: str = "payload",
                 output_column: str = "response",
                 headers: Optional[Dict[str, str]] = None,
                 timeout_s: float = 30.0):
        self._url = url
        self._in, self._out = payload_column, output_column
        self._headers = dict(headers or {})
        self._timeout = timeout_s

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        import urllib.request
        responses = []
        for payload in batch[self._in]:
            data = json.dumps(payload).encode() \
                if not isinstance(payload, (bytes, str)) else (
                    payload.encode() if isinstance(payload, str) else payload)
            req = urllib.request.Request(
                self._url, data=data,
                headers={"Content-Type": "application/json",
                         **self._headers})
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                responses.append(r.read().decode())
        out = dict(batch)
        out[self._out] = responses
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
        import torch

        from .._device import resolve_device
        from ..models.convert import params_to
        from ..models.gpt import GPTConfig, gpt_init

        self._device = resolve_device(device)
        self._cfg = config or GPTConfig.tiny()
        if params is None:
            params = gpt_init(self._cfg, torch.Generator().manual_seed(0),
                              self._device)
        self._params = params_to(params, self._device)
        self._max_new = max_new_tokens
        self._in, self._out = input_column, output_column

    def _decode(self, tokens):
        import torch

        from ..models.gpt import gpt_forward

        news = []
        with torch.inference_mode():
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
        import torch

        news = self._decode(torch.from_numpy(padded).to(self._device))
        news = news.cpu().numpy().astype(np.int32)
        out = dict(batch)
        out[self._out] = [news[i] for i in range(len(toks_list))]
        return out


@dataclass
class ProcessorConfig:
    """The standard pipeline's settings; ``device`` is where the GPT
    stage runs (``None``: the card)."""
    model: Optional[str] = None          # HF id for tokenizer/template
    batch_size: int = 16
    concurrency: int = 1
    max_new_tokens: int = 8
    use_chat_template: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)
    device: DeviceLike = None


@dataclass
class StageSpec:
    """A stateful stage to be constructed inside pool actors: the class
    plus ctor kwargs ship to each actor, so heavy state (tokenizer,
    model params on the device) is built once per actor instead of being
    re-pickled per block. ``num_gpus`` is what each actor reserves: a
    stage that runs on the card needs 1, since an actor without a GPU
    sees none."""

    cls: type
    kwargs: Dict[str, Any] = field(default_factory=dict)
    concurrency: int = 1
    num_gpus: float = 0


class Processor:
    """Chains stages over a ``ray_tpu_torch.data`` Dataset."""

    def __init__(self, stages: List[Any], batch_size: int = 16):
        self.stages = list(stages)
        self.batch_size = batch_size

    def __call__(self, dataset):
        for stage in self.stages:
            if isinstance(stage, StageSpec):
                dataset = dataset.map_batches(
                    stage.cls, batch_size=self.batch_size,
                    fn_constructor_kwargs=dict(stage.kwargs),
                    concurrency=stage.concurrency,
                    num_gpus=stage.num_gpus)
            else:
                dataset = dataset.map_batches(
                    stage, batch_size=self.batch_size)
        return dataset


def build_processor(config: ProcessorConfig) -> Processor:
    """Standard pipeline: [chat template] -> tokenize -> generate ->
    detokenize. Stateful stages are StageSpecs, constructed per pool
    actor, not on the driver; the GPT stage's actors each reserve a GPU
    unless ``config.device`` is the CPU."""
    on_cpu = str(config.device).split(":")[0] == "cpu"
    stages: List[Any] = []
    if config.use_chat_template:
        stages.append(StageSpec(ChatTemplateStage,
                                {"model": config.model}))
    stages.append(StageSpec(TokenizeStage, {"model": config.model}))
    stages.append(StageSpec(
        GPTInferenceStage, {"max_new_tokens": config.max_new_tokens,
                            "device": config.device},
        concurrency=config.concurrency, num_gpus=0 if on_cpu else 1))
    stages.append(StageSpec(DetokenizeStage, {"model": config.model}))
    return Processor(stages, batch_size=config.batch_size)
