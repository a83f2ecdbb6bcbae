"""The port's in-process records on the hot paths (``util/tracing.py``):
spans, counts and device ranges in the train step, the model code, the
device feed, the generation loop and Data's map, on the CPU at tiny
sizes.

They record in a torch.profiler session alone. Held here: with no
session, and with the control plane's ``tracing.enabled`` on or off, the
hot paths do no tracing work and add no autograd node; recording leaves
the loss and every gradient bit for bit; the counts are exact; spans
nest; the stamps are on the clock a torch.profiler trace uses; the store
keeps 65,536 records and counts every drop.
"""

import contextlib

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import ray_tpu_torch as rt
from ray_tpu_torch import data
from ray_tpu_torch.data.streaming import torch_device_feed
from ray_tpu_torch.llm.batch import GPTInferenceStage
from ray_tpu_torch.models.gpt import (GPTConfig, gpt_init, gpt_loss,
                                      make_train_step)
from ray_tpu_torch.models.vit import (ViTConfig, make_vit_train_step,
                                      vit_init, vit_loss)
from ray_tpu_torch.util import tracing

MARK = "_MarkBackward"


@pytest.fixture(autouse=True)
def fresh_store():
    """The control plane's tracing off and the store empty around each
    test."""
    was = tracing.enabled
    tracing.enabled = False
    tracing.clear_local()
    yield
    tracing.enabled = was
    tracing.clear_local()


def _gpt(remat=True):
    cfg = dataclasses.replace(GPTConfig.tiny(), remat=remat)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    return cfg, (toks[:, :-1], toks[:, 1:])


def _vit(remat=True):
    cfg = dataclasses.replace(ViTConfig.tiny(), remat=remat)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn((4, 32, 32, 3), generator=gen)
    labels = torch.randint(0, cfg.num_classes, (4,), generator=gen)
    return cfg, (images, labels)


FAMILIES = {
    "gpt": (_gpt, gpt_init, gpt_loss, make_train_step),
    "vit": (_vit, vit_init, vit_loss, make_vit_train_step),
}


def _params(family, cfg):
    init = FAMILIES[family][1]
    params = init(cfg, torch.Generator().manual_seed(1), "cpu")
    for p in _leaves(params):
        p.requires_grad_(True)
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _graph_nodes(t):
    """The names of every autograd node reachable from ``t``."""
    seen, out, stack = set(), [], [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        out.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return out


def _spans():
    return [r for r in tracing.local_records() if r["kind"] == "span"]


def _counts(name):
    return [r["n"] for r in tracing.local_records()
            if r["kind"] == "count" and r["name"] == name]


def recording():
    """A CPU-activity torch.profiler session: the hot paths record."""
    return profile(activities=[ProfilerActivity.CPU])


def _recording_if(on):
    return recording() if on else contextlib.nullcontext()


def _is_recording():
    return bool(tracing.profiler._is_profiler_enabled)


def _feed_batches():
    gen = np.random.default_rng(0)
    return [{"image": gen.standard_normal((4, 8, 8, 3)).astype(np.float32),
             "label": np.arange(4, dtype=np.int64) + k} for k in range(3)]


def _stage():
    return GPTInferenceStage(config=GPTConfig.tiny(), max_new_tokens=4,
                             device="cpu")


PROMPTS = [np.arange(3), np.arange(10) + 5, np.arange(17) + 7]


def _run_path(path):
    if path in FAMILIES:
        make, _, _, factory = FAMILIES[path]
        cfg, batch = make()
        init_state, step = factory(cfg, device="cpu")
        state = init_state(torch.Generator().manual_seed(1))
        step(state, batch)
    elif path == "feed":
        for _ in torch_device_feed(iter(_feed_batches()), device="cpu"):
            pass
    else:
        _stage()({"tokens": PROMPTS})


# ---------------------------------------------------------------------------
# no profiler session
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("control_plane", [False, True])
@pytest.mark.parametrize("path", ["gpt", "vit", "feed", "stage"])
def test_off_does_no_tracing_work(path, control_plane):
    """No profiler session: a GPT step, a ViT step, a feed epoch and a
    stage call call no tracing helper and store nothing, whether the
    control plane's tracing (``tracing.enabled``, which ``enable()`` hands
    to every process of a cluster) is on or off."""
    tracing.enabled = control_plane
    assert not _is_recording()
    ops = tracing.trace_ops()
    _run_path(path)
    assert tracing.trace_ops() == ops
    assert tracing.local_records() == []


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_off_adds_no_autograd_node(family):
    """With no profiler session the loss's graph holds no range node; in
    one, every range of the forward (remat off) adds two, one on its
    input and one on its output."""
    make, _, loss_fn, _ = FAMILIES[family]
    cfg, batch = make(remat=False)
    params = _params(family, cfg)
    off = _graph_nodes(loss_fn(params, batch, cfg))
    assert MARK not in off
    with recording():
        on = _graph_nodes(loss_fn(params, batch, cfg))
    ranges = [r for r in tracing.local_records() if r["kind"] == "range"]
    assert on.count(MARK) == 2 * len(ranges)
    assert len(on) == len(off) + 2 * len(ranges)


# ---------------------------------------------------------------------------
# tracing on: the same numbers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_on_leaves_loss_and_gradients_bit_identical(family, remat):
    make, _, loss_fn, factory = FAMILIES[family]
    cfg, batch = make(remat=remat)
    params = _params(family, cfg)
    leaves = _leaves(params)

    def loss_and_grads():
        loss = loss_fn(params, batch, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss_off, grads_off = loss_and_grads()
    with recording():
        loss_on, grads_on = loss_and_grads()
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(grads_on, grads_off):
        assert torch.equal(a, b)
    assert any(r["kind"] == "range" for r in tracing.local_records())

    # A whole step, traced and not, from the same params.
    after = []
    for on in (False, True):
        init_state, step = factory(cfg, device="cpu")
        state = init_state(params=_params(family, cfg))
        with _recording_if(on):
            state, out = step(state, batch)
        after.append((out["loss"], _leaves(state["params"])))
    assert torch.equal(after[0][0], after[1][0])
    for a, b in zip(after[0][1], after[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------
def test_generation_counts_are_exact():
    """Prompts of 3, 10 and 17 tokens go to the 32 bucket; at step k a
    row holds min(length + k, 32) real positions of the 32 computed."""
    stage = _stage()
    with recording():
        stage({"tokens": PROMPTS})
    lengths = np.array([len(p) for p in PROMPTS])
    assert _counts("llm.positions_computed") == [3 * 32] * 4
    assert _counts("llm.positions_real") == [
        int(np.minimum(lengths + k, 32).sum()) for k in range(4)]


def test_feed_counts_are_exact():
    batches = _feed_batches()
    with recording():
        got = list(torch_device_feed(iter(batches), device="cpu"))
    assert len(got) == 3
    assert _counts("feed.bytes") == [
        sum(v.nbytes for v in b.values()) for b in batches]
    names = [s["name"] for s in _spans()]
    # One fetch a batch and one at the end that finds none.
    assert names.count("feed.fetch") == 4
    assert names.count("feed.pin") == names.count("feed.upload") == 3


# ---------------------------------------------------------------------------
# nesting
# ---------------------------------------------------------------------------
def _parents():
    spans = _spans()
    by_id = {s["id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent"])) for s in spans]


def test_train_step_spans_nest():
    cfg, batch = _gpt()
    init_state, step = make_train_step(cfg, device="cpu")
    state = init_state(torch.Generator().manual_seed(1))
    with recording():
        step(state, batch)
    assert sorted(_parents()) == sorted([
        ("train.step", None), ("train.forward", "train.step"),
        ("train.backward", "train.step"), ("train.optimizer", "train.step")])
    ranges = {r["name"]: r for r in tracing.local_records()
              if r["kind"] == "range"}
    # The step's phases and the loss are ranges; the loss has a backward.
    assert {"train.forward", "train.backward", "train.optimizer",
            "model.loss", "model.norm", "model.rope",
            "model.act"} <= set(ranges)
    assert ranges["model.loss"]["backward_ms"] > 0
    # qkv_heads' ranges of the forward (not those of remat's recompute)
    # stamp a backward once all of q, k and v's gradients are in.
    assert any(r["backward_ms"] for r in tracing.local_records()
               if r["kind"] == "range" and r["name"] == "model.rope")
    assert ranges["train.optimizer"]["backward_ms"] is None
    spans = {s["name"]: s for s in _spans()}
    for phase in ("train.forward", "train.backward", "train.optimizer"):
        assert spans["train.step"]["start_ns"] <= spans[phase]["start_ns"]
        assert spans[phase]["end_ns"] <= spans["train.step"]["end_ns"]


def test_stage_call_spans_nest():
    stage = _stage()
    with recording():
        stage({"tokens": PROMPTS})
    assert sorted(_parents()) == sorted([
        ("llm.call", None), ("llm.pad", "llm.call"),
        ("llm.decode", "llm.call"), ("llm.fetch", "llm.call")])
    heads = [r for r in tracing.local_records()
             if r["kind"] == "range" and r["name"] == "model.head"]
    assert len(heads) == 4 and all(h["backward_ms"] is None for h in heads)


class _Double:
    def __call__(self, batch):
        return {"x": batch["x"] * 2}


def test_data_and_feed_spans_nest():
    """map_batches in local mode: data.udf inside data.apply; the feed's
    fetch holds the Data iterator's data.get and data.batch."""
    rt.init(local_mode=True, ignore_reinit_error=True)
    try:
        ds = data.from_items([{"x": i} for i in range(16)],
                             override_num_blocks=4)
        with recording():
            out = list(ds.map_batches(_Double, batch_size=4, concurrency=1)
                       .iter_torch_batches(batch_size=4, device="cpu"))
    finally:
        rt.shutdown()
    assert sorted(int(v) for b in out for v in b["x"]) == list(
        range(0, 32, 2))
    pairs = _parents()
    assert pairs.count(("data.udf", "data.apply")) == 4
    assert ("data.get", "feed.fetch") in pairs
    assert ("data.batch", "feed.fetch") in pairs
    assert all(p != "data.udf" for n, p in pairs if n == "data.apply")


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------
def test_stamps_fall_between_wall_clock_reads():
    before = time.time_ns()
    with tracing.local_span("a"):
        with tracing.local_span("b"):
            time.sleep(0.001)
        tracing.local_count("c", 3)
    after = time.time_ns()
    recs = tracing.local_records()
    stamps = [t for r in recs for t in (
        (r["start_ns"], r["end_ns"]) if r["kind"] == "span"
        else (r["ns"],))]
    assert all(before <= t <= after for t in stamps)
    spans = {s["name"]: s for s in _spans()}
    assert spans["b"]["end_ns"] - spans["b"]["start_ns"] >= 1_000_000


def test_stamps_match_the_profilers_clock(tmp_path):
    """A CPU-activity torch.profiler session turns recording on, and a
    span's stamps lie within 1 ms of the profiler's event for the same
    region (its ``ts`` + ``baseTimeNanoseconds``)."""
    assert not _is_recording()
    with recording() as prof:
        assert _is_recording()
        for i in range(4):
            with record_function(f"region{i}"):
                with tracing.local_span(f"span{i}"):
                    time.sleep(0.002)
    assert not _is_recording()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    spans = {s["name"]: s for s in _spans()}
    # The first region pays the profiler's own warm-up.
    for i in range(1, 4):
        (ev,) = [e for e in trace["traceEvents"]
                 if e.get("name") == f"region{i}"]
        start_us = ev["ts"] + base_us
        span = spans[f"span{i}"]
        assert abs(span["start_ns"] / 1e3 - start_us) < 1000
        assert abs(span["end_ns"] / 1e3 - (start_us + ev["dur"])) < 1000


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------
def test_store_holds_the_cap_and_counts_every_drop():
    for i in range(tracing.LOCAL_CAP):
        tracing.local_count("n", i)
    assert tracing.local_dropped() == (0, 0)
    assert len(tracing.local_records()) == tracing.LOCAL_CAP == 65536
    stamps = [r["ns"] for r in tracing.local_records()[:10]]
    for i in range(10):
        tracing.local_count("n", tracing.LOCAL_CAP + i)
    recs = tracing.local_records()
    assert len(recs) == tracing.LOCAL_CAP
    assert tracing.local_dropped() == (10, stamps[-1])
    assert recs[0]["n"] == 10 and recs[-1]["n"] == tracing.LOCAL_CAP + 9
    tracing.clear_local()
    assert tracing.local_records() == [] and tracing.local_dropped() == (0, 0)


def test_control_plane_spans_share_the_clock_and_resolve_otel_once(
        monkeypatch):
    tracing.enabled = True
    tracing.drain_spans()
    before = time.time_ns() / 1e9
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
    after = time.time_ns() / 1e9
    spans, dropped = tracing.drain_spans()
    assert dropped == 0
    inner, outer = spans
    assert before <= outer["start"] <= inner["start"] <= inner["end"] \
        <= outer["end"] <= after
    assert inner["parent_span_id"] == outer["span_id"]
    assert inner["trace_id"] == outer["trace_id"]
    assert len(outer["trace_id"]) == 32 and len(outer["span_id"]) == 16
    assert inner["span_id"] != outer["span_id"]
    int(outer["trace_id"], 16), int(outer["span_id"], 16)
    # Resolved once: a later span tries no import of opentelemetry.
    assert tracing._otel_tracer is not tracing._UNRESOLVED
    real_import = __import__

    def guarded(name, *a, **kw):
        assert not name.startswith("opentelemetry"), name
        return real_import(name, *a, **kw)

    monkeypatch.setattr("builtins.__import__", guarded)
    with tracing.span("again"):
        pass
    monkeypatch.undo()
    tracing.drain_spans()


def test_gate_binds_torchs_profiler_once_torch_is_imported():
    """The Data layer imports tracing without torch: the gate reads False
    then, and once torch is imported its first read binds the profiler
    module, with no call from any other module."""
    code = (
        "import sys\n"
        "from ray_tpu_torch.util import tracing\n"
        "assert 'torch' not in sys.modules\n"
        "assert tracing.profiler._is_profiler_enabled is False\n"
        "import torch\n"
        "from torch.profiler import profile, ProfilerActivity\n"
        "with profile(activities=[ProfilerActivity.CPU]):\n"
        "    assert tracing.profiler._is_profiler_enabled\n"
        "assert tracing.profiler is torch.autograd.profiler\n"
        "assert not tracing.profiler._is_profiler_enabled\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
