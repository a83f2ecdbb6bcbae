"""The trace's reduction on hand-made events: the window between the two
marker kernels, busy time as a union, the copies' overlap, and idle gaps
named by the harness's spans and the CUDA runtime call that covers them."""

import pytest

from benchmarks.trace import (MARKER, Trace, kernel_group, overlap_share,
                              union_length)


def ev(cat, name, ts_us, dur_us):
    return {"cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


EVENTS = [
    ev("kernel", "before_the_window", 0, 50),
    ev("kernel", f"at::cuda::{MARKER}(long)", 100, 1),
    ev("kernel", "ampere_bf16_gemm", 101, 99),           # 101-200
    ev("kernel", "flash_fwd_kernel", 150, 100),          # 150-250, stream 2
    ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 240, 20),  # 240-260
    ev("cuda_runtime", "cudaStreamSynchronize", 255, 200),  # 255-455
    ev("cuda_runtime", "cudaLaunchKernel", 300, 5),      # inside the sync
    ev("kernel", "vectorized_elementwise_kernel", 500, 100),  # 500-600
    ev("kernel", f"at::cuda::{MARKER}(long)", 699, 1),
    ev("kernel", "after_the_window", 800, 50),
]


def test_window_runs_from_marker_to_marker():
    t = Trace(EVENTS)
    assert t.start == pytest.approx(100e-6)
    assert t.end == pytest.approx(700e-6)
    assert t.window_s == pytest.approx(600e-6)
    # 101-260 and 500-600; the markers are not work.
    assert t.busy_s == pytest.approx(259e-6)
    assert t.idle_share() == pytest.approx(1 - 259 / 600)
    assert t.port_kernel_seconds()["flash_fwd"] == pytest.approx(100e-6)
    assert all(MARKER not in name for _, _, name in t.kernels)


def test_copy_overlap_and_groups():
    t = Trace(EVENTS)
    assert t.htod_overlap_share() == pytest.approx(10 / 20)
    assert overlap_share([], [(0, 1)]) is None
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert kernel_group("ampere_bf16_gemm") == "matmul (cuBLAS)"
    groups = dict(t.device_ops())
    assert groups["copies and memsets (non-kernel)"] == pytest.approx(20e-6)


def test_idle_gaps_are_named_by_spans_and_runtime_calls():
    t = Trace(EVENTS)
    host_start = 10.0       # the host clock when the first marker ran
    spans = [("bench.step", 10.0, 10.0006),
             ("bench.feed_next", 10.0001, 10.0004)]
    gaps = dict(t.idle_gaps(spans, host_start))
    # 260-500: inside the feed's span, the sync until 455 covering its
    # start; 600-700: inside the step alone, no runtime call; 100-101:
    # the start marker's own microsecond.
    assert gaps == {
        "launch spacing (gaps under 20 us)": pytest.approx(1e-6),
        "bench.feed_next / cudaStreamSynchronize": pytest.approx(240e-6),
        "bench.step / no CUDA call": pytest.approx(100e-6)}


def test_without_markers_the_device_events_bound_the_window():
    t = Trace([e for e in EVENTS if MARKER not in e["name"]])
    assert t.start == 0.0 and t.end == pytest.approx(850e-6)
