"""The PyTorch port's GPT and serving path held against the JAX package.

Weights are drawn once by ``ray_tpu.models.gpt_init`` and carried to the
port with ``from_jax_params`` (torch cannot replay ``jax.random``); token
inputs come from numpy with a fixed seed; decoding is greedy. Everything
runs on the CPU, where the port's attention is its plain version; each
test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.batch import DetokenizeStage as JDetokenize
from ray_tpu.llm.batch import GPTInferenceStage as JInference
from ray_tpu.llm.batch import TokenizeStage as JTokenize
from ray_tpu.llm.serving import LLMEngine as JEngine
from ray_tpu.models import GPTConfig as JConfig
from ray_tpu.models import gpt_forward as j_forward
from ray_tpu.models import gpt_init as j_init
from ray_tpu.models.generate import generate as j_generate
from ray_tpu.ops.attention import _kernel_ok as j_kernel_ok
from ray_tpu_torch.llm import (ContinuousBatchingEngine, DetokenizeStage,
                               GPTInferenceStage, LLMEngine, TokenizeStage)
from ray_tpu_torch.models import GPTConfig, from_jax_params, gpt_forward
from ray_tpu_torch.models.generate import generate

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    # The shapes here are tiny: two threads lose nothing, and spare the
    # cores that the suite's other test workers share.
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(base_j, base_t, dtype="float32", **fields):
    jdt, tdt = _DTYPES[dtype]
    return (dataclasses.replace(base_j, dtype=jdt, **fields),
            dataclasses.replace(base_t, dtype=tdt, **fields))


def _weights(jcfg, seed=0):
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _engine_configs(dtype="float32"):
    """The engines' default shape, narrowed: byte vocab, 2 layers."""
    fields = dict(vocab_size=272, d_model=64, n_heads=4, n_layers=2,
                  d_ff=128, max_seq_len=128)
    return _configs(JConfig(), GPTConfig(), dtype, **fields)


class TestConvert:
    def test_bf16_params_carry_bits(self):
        jcfg, _ = _configs(JConfig.tiny(), GPTConfig.tiny(), "bfloat16")
        jp, tp = _weights(jcfg)
        assert tp["embed"].dtype == torch.bfloat16
        assert tp["lnf"].dtype == torch.float32
        jl, tl = jp["layers"][1], tp["layers"][1]
        assert set(tl) == set(jl)
        for key in jl:
            assert tuple(tl[key].shape) == jl[key].shape
            # Exact: the bits are reinterpreted, not rounded again.
            np.testing.assert_array_equal(
                tl[key].float().numpy(),
                np.asarray(jl[key].astype(jnp.float32)))

    def test_dtype_casts_matrices_only(self):
        jcfg, _ = _configs(JConfig.tiny(), GPTConfig.tiny())
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu",
                             dtype=torch.bfloat16)
        assert tp["layers"][0]["wqkv"].dtype == torch.bfloat16
        assert tp["layers"][0]["ln1"].dtype == torch.float32


class TestGPTForward:
    @pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                           ("bfloat16", 2e-2)])
    def test_logits_match_jax(self, dtype, tol):
        jcfg, tcfg = _configs(JConfig.tiny(), GPTConfig.tiny(), dtype)
        jp, tp = _weights(jcfg)
        toks = np.random.default_rng(0).integers(0, 512, (2, 16))
        ref = np.asarray(j_forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
        out = gpt_forward(tp, torch.from_numpy(toks), tcfg)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        # f32: the same math (<=1e-4 of the logits' scale); bf16: both
        # round every matmul output to bf16, at slightly other points.
        err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
        assert err <= tol, err


class TestGenerate:
    def test_greedy_tokens_match_jax(self):
        jcfg, tcfg = _configs(JConfig.tiny(), GPTConfig.tiny())
        jp, tp = _weights(jcfg, seed=1)
        prompt = np.random.default_rng(1).integers(0, 512, (2, 7))
        ref = np.stack([np.asarray(t) for t in
                        j_generate(jp, jcfg, prompt, max_new_tokens=10)])
        out = torch.stack(list(generate(tp, tcfg, prompt,
                                        max_new_tokens=10)))
        # Greedy decoding on the same weights: exact token equality.
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_sampling_is_seeded(self):
        jcfg, tcfg = _configs(JConfig.tiny(), GPTConfig.tiny())
        _, tp = _weights(jcfg)
        prompt = np.arange(5)[None]
        a, b = ([int(t[0]) for t in generate(tp, tcfg, prompt, 6,
                                              temperature=1.0, seed=3)]
                for _ in range(2))
        assert a == b and all(0 <= t < 512 for t in a)


class TestServing:
    PROMPTS = ["hello", "the quick brown fox", "ab", "zzzz yyyy",
               "continuous batching"]

    def test_engines_match_jax_and_each_other(self):
        jcfg, tcfg = _engine_configs()
        jp, tp = _weights(jcfg, seed=2)
        jax_out = [JEngine(cfg=jcfg, params=jp).complete(p, 12)
                   for p in self.PROMPTS]
        single = LLMEngine(cfg=tcfg, params=tp, device="cpu")
        single_out = [single.complete(p, 12) for p in self.PROMPTS]
        # Greedy on the same weights: the same text, byte for byte.
        assert single_out == jax_out
        assert sum(len(t) for t in jax_out) > 0
        # Two slots for five requests: later requests reuse freed slots
        # and join a batch that is already decoding.
        cont = ContinuousBatchingEngine(cfg=tcfg, params=tp, max_batch=2,
                                        device="cpu")
        try:
            streams = [cont.submit(p, 12) for p in self.PROMPTS]
            assert ["".join(s) for s in streams] == single_out
        finally:
            cont.close()
            cont._thread.join(timeout=30)
        assert not cont._thread.is_alive()

    def test_closed_engine_refuses(self):
        _, tcfg = _engine_configs()
        cont = ContinuousBatchingEngine(cfg=tcfg, device="cpu")
        cont.close()
        with pytest.raises(RuntimeError, match="closed"):
            cont.submit("x")

    def test_prefill_failure_ends_the_stream(self):
        _, tcfg = _engine_configs()
        cont = ContinuousBatchingEngine(cfg=tcfg, device="cpu")

        def broken(*args):
            raise ValueError("prefill failed")
        cont._prefill = broken
        with pytest.raises(ValueError, match="prefill failed"):
            "".join(cont.submit("hello", 4))
        cont._thread.join(timeout=30)
        with pytest.raises(RuntimeError, match="closed"):
            cont.submit("x")


class TestBatchSlice:
    """The batch serving slice end to end: tokenize -> GPTInferenceStage
    -> detokenize, port against the JAX stages at a T=128 bucket, where
    the JAX stage's attention runs its Pallas forward kernel in interpret
    mode (the port's, on the CPU, runs the plain version)."""

    def test_stages_match_jax(self, monkeypatch):
        monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
        assert j_kernel_ok(128)
        jcfg, tcfg = _configs(JConfig.tiny(), GPTConfig.tiny())
        jp, tp = _weights(jcfg, seed=3)
        rng = np.random.default_rng(3)
        prompts = ["".join(chr(c) for c in rng.integers(97, 123, n))
                   for n in (70, 100, 128)]
        batch = {"prompt": prompts}
        jb = JTokenize()(batch)
        tb = TokenizeStage()(batch)
        for a, b in zip(jb["tokens"], tb["tokens"]):
            np.testing.assert_array_equal(a, b)
        jb = JInference(config=jcfg, params=jp, max_new_tokens=6)(jb)
        tb = GPTInferenceStage(config=tcfg, params=tp, max_new_tokens=6,
                               device="cpu")(tb)
        # Greedy over a 128-token bucket, same weights: equal tokens.
        np.testing.assert_array_equal(np.stack(tb["generated_tokens"]),
                                      np.stack(jb["generated_tokens"]))
        assert JDetokenize()(jb)["generated_text"] == \
            DetokenizeStage()(tb)["generated_text"]
