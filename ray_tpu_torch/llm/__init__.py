"""ray_tpu_torch.llm: LLM serving engines and batch stages on PyTorch.

Counterpart of ``ray_tpu.llm``: the single-stream engine, the
continuous-batching engine, and the tokenize / generate / detokenize
batch stages. The Serve app and the Data ``Processor`` that host them
wait for the port's control plane.
"""
from .batch import DetokenizeStage, GPTInferenceStage, TokenizeStage
from .continuous import ContinuousBatchingEngine
from .serving import ByteTokenizer, LLMEngine

__all__ = ["ByteTokenizer", "ContinuousBatchingEngine", "DetokenizeStage",
           "GPTInferenceStage", "LLMEngine", "TokenizeStage"]
