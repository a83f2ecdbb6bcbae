"""The program's own records read onto a traced window
(``program_trace.py``), the eleven metrics that read them and
``program_checks.py``'s checks, on hand-made records: the window filter,
own time outside the user's function, idle gaps labelled by program
spans, and nothing after a dropped record or from a program that keeps
no records."""

import pytest

from benchmarks import harness, program_checks, program_trace
from benchmarks.trace import MARKER, Trace

# Host perf_counter seconds of the window, and wall = perf + WALL.
START, END = 10.0, 11.0
WALL = 1.7e9


def ns(t):
    return int(round((t + WALL) * 1e9))


def span(name, sid, parent, a, b):
    return {"kind": "span", "name": name, "id": sid, "parent": parent,
            "start_ns": ns(a), "end_ns": ns(b)}


def rng(name, t, fwd, bwd=None):
    return {"kind": "range", "name": name, "start_ns": ns(t),
            "forward_ms": fwd, "backward_ms": bwd}


def count(name, t, n):
    return {"kind": "count", "name": name, "ns": ns(t), "n": n}


RECORDS = [
    span("train.step", 1, 0, 9.5, 9.6),          # before the window
    span("train.step", 2, 0, 10.1, 10.3),
    span("train.forward", 3, 2, 10.1, 10.2),
    span("train.step", 4, 0, 10.95, 11.05),      # cut by the window's end
    rng("model.loss", 9.9, 100.0, 100.0),        # before the window
    rng("model.loss", 10.15, 2.0, 3.0),
    rng("model.norm", 10.2, 1.0),
    rng("model.rope", 10.25, 0.5, 0.5),
    rng("model.act", 10.26, 0.25, 0.25),
    rng("train.forward", 10.1, 300.0),
    rng("train.backward", 10.2, 100.0),
    rng("train.optimizer", 10.28, 1.5),
    span("feed.fetch", 5, 0, 10.40, 10.50),
    span("feed.pin", 6, 0, 10.50, 10.60),
    count("feed.bytes", 10.6005, 300_000_000),   # counted as the pin ends
    span("feed.upload", 7, 0, 10.60, 10.61),
    count("feed.bytes", 11.2, 10**12),           # after the window
    count("llm.positions_computed", 10.5, 100),
    count("llm.positions_real", 10.5, 85),
    count("llm.positions_computed", 11.5, 1000),  # after the window
    span("data.get", 8, 0, 10.70, 10.72),
    span("data.apply", 9, 0, 10.72, 10.90),
    span("data.udf", 10, 9, 10.73, 10.89),
    span("llm.call", 11, 10, 10.73, 10.88),
    rng("model.head", 10.75, 4.0),
    rng("model.head", 10.80, 4.0),
    rng("model.head", 10.95, 100.0),             # in no call of the window
    span("data.batch", 12, 0, 10.90, 10.91),
]


def ev(cat, name, ts_us, dur_us):
    return {"cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


# On the trace's clock the window runs 0.001-1.001 s: busy 0.001-0.451
# and 0.561-1.000, idle 0.451-0.561 (host 10.450-10.560, under the feed's
# fetch and pin), 1.000-1.001 (host 10.999-11.000, under the last
# train.step) and the start marker's own microsecond.
EVENTS = [
    ev("kernel", f"at::cuda::{MARKER}(long)", 1000, 1),
    ev("kernel", "ampere_bf16_gemm", 1001, 449999),
    ev("kernel", "vectorized_elementwise_kernel", 561000, 439000),
    ev("kernel", f"at::cuda::{MARKER}(long)", 1000000, 1000),
]


class FakeTime:
    """Wall = perf_counter + WALL, read after the window."""

    @staticmethod
    def perf_counter_ns():
        return int(12.0 * 1e9)

    @staticmethod
    def time_ns():
        return ns(12.0)


@pytest.fixture
def ctx(monkeypatch):
    from ray_tpu_torch.util import tracing

    monkeypatch.setattr(tracing, "local_records", lambda: list(RECORDS))
    monkeypatch.setattr(tracing, "local_dropped", lambda: (0, 0))
    monkeypatch.setattr(program_trace, "time", FakeTime)
    window = {"start": START, "end": END, "seconds": END - START,
              "steps": 2}
    return harness.MetricContext(None, None, window, Trace(EVENTS))


def test_clock_and_window_filter(ctx):
    p = program_trace.read(ctx)
    assert p.offset == pytest.approx(0.001 - START)
    assert p.host_s("train.step") == pytest.approx(0.2 + 0.05)
    assert p.spans_named("train.step") == [pytest.approx((10.1, 10.3))]
    assert p.device_ms(("model.loss",)) == pytest.approx(5.0)
    assert p.device_ms(("model.none",)) is None
    assert p.count("llm.positions_computed") == 100
    assert program_trace.read(ctx) is p      # one reading a run


def test_own_time_outside_the_users_function(ctx):
    p = program_trace.read(ctx)
    own = p.exclusive_s(lambda n: n.startswith("data.") and n != "data.udf",
                        lambda n: n == "data.udf")
    # get, apply and batch cover 10.70-10.91; the function 10.73-10.89.
    assert own == pytest.approx(0.21 - 0.16)


def test_idle_gaps_are_labelled_by_program_spans(ctx):
    p = program_trace.read(ctx)
    gaps = dict(p.idle_gaps(ctx.trace))
    assert gaps == {"feed.fetch": pytest.approx(0.110),
                    "train.step": pytest.approx(0.001),
                    "launch spacing (gaps under 20 us)": pytest.approx(1e-6)}
    assert p.idle_under(ctx.trace, "feed.") == pytest.approx(0.110)
    assert p.idle_under(ctx.trace, "llm.") == 0.0


@pytest.mark.parametrize("name, want", [
    ("loss_device_ms.train", 5.0 / 2),
    ("pointwise_device_ms.train", (1.0 + 1.0 + 0.5) / 2),
    ("pointwise_device_ms.fed", (1.0 + 1.0 + 0.5) / 2),
    ("feed_fetch_ms.fed", 100.0 / 2),
    ("feed_pin_ms.fed", 100.0 / 2),
    ("feed_idle_share.fed", 0.110 / 1.0),
    ("head_device_ms.infer", 8.0),
    ("padding_share.infer", 1 - 85 / 100),
    ("data_self_share.infer", 0.05),
    ("optimizer_device_ms.train", 1.5 / 2),
    ("feed_pin_gbps.fed", 0.3 / 0.1),
])
def test_metric_reads_the_records(ctx, name, want):
    assert harness.load_metric(name)(ctx) == pytest.approx(want, rel=1e-6)


NEW = ["loss_device_ms.train", "pointwise_device_ms.train",
       "pointwise_device_ms.fed", "feed_fetch_ms.fed", "feed_pin_ms.fed",
       "feed_idle_share.fed", "head_device_ms.infer", "padding_share.infer",
       "data_self_share.infer", "optimizer_device_ms.train",
       "feed_pin_gbps.fed"]


def test_nothing_after_a_dropped_record_of_the_window(ctx, monkeypatch):
    from ray_tpu_torch.util import tracing

    # Drops before the window leave it whole.
    monkeypatch.setattr(tracing, "local_dropped", lambda: (3, ns(9.0)))
    assert program_trace.read(ctx) is not None
    program_trace._LAST.clear()
    monkeypatch.setattr(tracing, "local_dropped", lambda: (1, ns(10.5)))
    assert program_trace.read(ctx) is None
    assert all(harness.load_metric(m)(ctx) is None for m in NEW)


def test_nothing_from_a_program_without_records(ctx, monkeypatch):
    from ray_tpu_torch.util import tracing

    monkeypatch.delattr(tracing, "local_records")
    program_trace._LAST.clear()
    assert program_trace.read(ctx) is None
    assert all(harness.load_metric(m)(ctx) is None for m in NEW)


def test_nothing_where_the_window_holds_no_records(ctx, monkeypatch):
    from ray_tpu_torch.util import tracing

    monkeypatch.setattr(tracing, "local_records", lambda: [])
    program_trace._LAST.clear()
    assert all(harness.load_metric(m)(ctx) is None for m in NEW)


def test_checks_hold_the_records_against_the_trace(ctx):
    """program_checks.checks: the phases against the trace's busy time,
    the loss and pointwise ranges against glue, GEMM and idle time, the
    feed's idle share beside the device's, the gaps by program span."""
    metrics = {m: {"value": harness.load_metric(m)(ctx)}
               for m in ("loss_device_ms.train", "pointwise_device_ms.train",
                         "feed_idle_share.fed")}
    metrics["glue_device_ms.train"] = {"value": 219.5}
    metrics["device_idle_share.train"] = {"value": 0.111}
    got = program_checks.checks(ctx, metrics)
    t = ctx.trace
    busy_ms = 1e3 * t.busy_s / 2
    assert got["phase_ms"] == {"train.forward": 150.0,
                               "train.backward": 50.0,
                               "train.optimizer": 0.75}
    assert got["phases_over_busy"] == pytest.approx(200.75 / busy_ms)
    assert got["ranges_ms"] == pytest.approx(2.5 + 1.25)
    # The GEMM ran 449.999 ms of the window, 2 steps.
    assert got["glue_gemm_idle_ms"] == pytest.approx(
        219.5 + 449.999 / 2 + 1e3 * (t.window_s - t.busy_s) / 2)
    assert got["feed_idle_share"] == pytest.approx(0.110)
    assert got["device_idle_share"] == 0.111
    assert dict(got["idle_gaps"])["feed.fetch"] == pytest.approx(0.110)
    assert "padding_share" not in got


def test_checks_recompute_padding_from_the_lengths(ctx):
    """Two rows of 3 and 30 tokens in a 32 bucket, 4 new tokens: 143 of
    256 positions are real."""
    ctx.window.update(calls=[(10.1, 10.9, [0, 1], 32)], lengths=[3, 30],
                      max_new_tokens=4)
    assert program_checks.padding_from_lengths(ctx.window) == \
        pytest.approx(1 - 143 / 256)
    got = program_checks.checks(
        ctx, {"padding_share.infer": {"value": 0.15}})
    assert got["padding_share"] == 0.15
    assert got["padding_from_lengths"] == pytest.approx(1 - 143 / 256)


def test_no_checks_without_records(ctx, monkeypatch):
    from ray_tpu_torch.util import tracing

    monkeypatch.delattr(tracing, "local_records")
    program_trace._LAST.clear()
    assert program_checks.checks(ctx, {}) == {}
    assert program_trace.last_context() is ctx
