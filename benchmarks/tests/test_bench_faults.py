"""The comparison catches a broken timed path: each cell run whole on the
CPU at a tiny size, past the harness's look for a card, with the
program's real limits, comes out correct as it stands and not correct
with each fault the cell can have planted underneath (one chip: no
exchange between chips to leave out)."""

import contextlib

import pytest
import torch

from benchmarks import harness
from benchmarks.run import run_cell

TRAIN = ["gpt2-small.train.b64", "vit-b16.train-fed.b512"]
INFER = "gpt2-small.batch-infer.code"
SEED = 2**31 + 77


def run(tiny, cell, seconds=0.5):
    root, bench = tiny
    return run_cell(cell, SEED, seconds, False, torch.device("cpu"), 0.0,
                    bench_dir=bench, root=root)


@contextlib.contextmanager
def broken_step(cell, wrap):
    """The cell's family builds train steps whose every call goes
    through ``wrap(step, state, batch)``."""
    family = harness.find_cell(cell).family
    made = family.port_train_step

    def factory(c, device):
        init_state, step = made(c, device)
        return init_state, lambda state, batch: wrap(step, state, batch)
    family.port_train_step = factory
    try:
        yield
    finally:
        family.port_train_step = made


@pytest.mark.parametrize("cell", TRAIN + [INFER])
def test_sound_runs_are_correct(tiny, cell):
    out = run(tiny, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(tiny, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self: None)
    out = run(tiny, cell)
    assert not out["correct"]
    assert out["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(tiny, cell):
    def half(step, state, batch):
        return step(state, tuple(x[:x.shape[0] // 2] for x in batch))
    with broken_step(cell, half):
        out = run(tiny, cell)
    assert not out["correct"], out["checks"]


def test_a_token_altered_where_it_is_produced(tiny, monkeypatch):
    from ray_tpu_torch.llm.batch import GPTInferenceStage

    decode = GPTInferenceStage._decode

    def altered(self, tokens):
        news = decode(self, tokens).clone()
        news[:, 0] = (news[:, 0] + 1) % self._cfg.vocab_size
        return news
    monkeypatch.setattr(GPTInferenceStage, "_decode", altered)
    out = run(tiny, INFER)
    assert not out["correct"], out["checks"]


def test_a_feed_that_reorders_rows(tiny, monkeypatch):
    from ray_tpu_torch.data import streaming

    feed = streaming.torch_device_feed

    def shuffled(batches, **kw):
        for b in feed(batches, **kw):
            yield {k: v.flip(0) for k, v in b.items()}
    monkeypatch.setattr(streaming, "torch_device_feed", shuffled)
    out = run(tiny, TRAIN[1])
    assert not out["correct"]
    assert out["checks"]["feed_mismatch"]["value"] > 0
