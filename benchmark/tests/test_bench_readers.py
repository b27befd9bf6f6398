"""Each per-layer reader on a canned profiler trace whose answers are
known by hand, and the trace reading under them."""

import json

import pytest

from benchmark.harness import spec, trace
from benchmark.reference.roofline import BF16_TENSOR_FLOP_PER_S


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def canned_events():
    """A window of 2 units (1000 us): the backbone's range holds B2's op
    with one kernel of 100 us; a sort kernel of 50 us runs later; the
    backward thread's B1 operator launches one kernel of 20 us; a stream
    sync and a blocking copy wait; a launch outside the window does not
    count."""
    return [
        ev("user_annotation", "bench/window", 0, 1000),
        ev("user_annotation", "bench/batch", 0, 500),
        ev("user_annotation", "bench/batch", 500, 500),
        ev("user_annotation", "bench/backbone", 10, 180),
        ev("cpu_op", "xdt::fused_sepconv", 20, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 25, 5, corr=1),
        ev("kernel", "sepconv_tma_kernel", 40, 100, tid=7, corr=1),
        ev("user_annotation", "bench/proposals", 200, 200),
        ev("cpu_op", "aten::sort", 310, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 312, 4, corr=2),
        ev("kernel", "sort_kernel", 320, 50, tid=7, corr=2),
        ev("cuda_runtime", "cudaStreamSynchronize", 340, 40, corr=3),
        ev("cpu_op", "xdt::psroi_align_bwd", 600, 30, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 605, 5, tid=2, corr=4),
        ev("kernel", "psroi_bwd_kernel", 620, 20, tid=7, corr=4),
        ev("cuda_runtime", "cudaMemcpy", 700, 10, corr=5),
        ev("gpu_memcpy", "Memcpy DtoH", 702, 6, tid=7, corr=5),
        ev("kernel", "ncclDevKernel_AllReduce_Sum_f32", 800, 30, tid=8),
        ev("cuda_runtime", "cudaLaunchKernel", 1200, 5, corr=6),
        ev("kernel", "late_kernel", 1210, 10, tid=7, corr=6),
    ]


INFO = {"images_per_s": 800.0,
        "flop_per_image": 6.0e10, "b2_bound_ms_per_unit": 0.025,
        "b1_bwd_bound_ms_per_unit": 0.004}


@pytest.fixture
def window(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": canned_events()}))
    return trace.Window(trace._events(str(path)), 2, INFO)


def test_window(window):
    assert window.window_s == pytest.approx(1e-3)
    assert window.busy_s == pytest.approx((100 + 50 + 20 + 6 + 30) * 1e-6)
    assert window.launches() == 3          # the late kernel's launch is out
    assert window.syncs() == 2
    assert window.kernels_under(lambda n: n.startswith("xdt::")) == 2


EXPECTED = {
    "device_idle_pct.serve": 100 * (1 - 206 / 1000),
    "device_idle_pct.train": 100 * (1 - 206 / 1000),
    "allreduce_device_ms": 0.030 / 2,
    "mfu_pct.serve": 100 * 6.0e10 * 800.0 / BF16_TENSOR_FLOP_PER_S,
    "mfu_pct.train": 100 * 6.0e10 * 800.0 / BF16_TENSOR_FLOP_PER_S,
    "launches_per_batch.serve": 1.5,
    "launches_per_step.train": 1.5,
    "host_syncs_per_batch": 1.0,
    "backbone_device_ms": 0.100 / 2,
    "b2_roofline": 100 * 0.025 * 2 / 0.100,
    "b1_bwd_roofline": 100 * 0.004 * 2 / 0.020,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(window, metric):
    assert spec.metric_reader(metric)(window) == pytest.approx(
        EXPECTED[metric])


def test_every_per_layer_metric_has_a_case():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    assert {m["name"] for m in bench["per_layer"]} <= set(EXPECTED)


@pytest.mark.parametrize("metric", ["backbone_device_ms", "b2_roofline",
                                    "b1_bwd_roofline",
                                    "allreduce_device_ms"])
def test_reader_finds_nothing(metric):
    """A window without the range or operator reads nothing, never 0."""
    events = [ev("user_annotation", "bench/window", 0, 100),
              ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
              ev("kernel", "k", 10, 10, tid=7, corr=1)]
    w = trace.Window(events, 1, {})
    assert spec.metric_reader(metric)(w) is None


@pytest.mark.parametrize("metric", ["b2_roofline", "b1_bwd_roofline"])
def test_roofline_reads_nothing_from_a_window_that_lost_kernels(window,
                                                                 metric):
    window.lost = (1, 2)
    assert spec.metric_reader(metric)(window) is None


def test_breakdown(window):
    b = window.breakdown()
    assert b["device_ops"][0] == ["sepconv_tma_kernel", pytest.approx(1e-4)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(1e-3 - 206e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert any(n.startswith("bench/proposals") for n in gaps)


def test_a_lost_window_is_marked(monkeypatch, tmp_path):
    """A window whose trace keeps fewer kernels under the program's
    operators than were launched is profiled again, then marked, and the
    ranks of a group agree on profiling again."""
    import torch
    events = canned_events()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace, "_events", lambda path: events)
    monkeypatch.setattr(trace.time, "sleep", lambda s: None)
    counter = iter(range(0, 100, 3))        # 3 launched a try, 2 traced
    agreed = []

    def agree(whole):
        agreed.append(whole)
        return whole
    w = trace.traced(lambda i: None, 2, INFO, counters=lambda: next(counter),
                     agree=agree)
    assert w.lost == (2, 3) and agreed == [False] * 3
    counter = iter(range(0, 100, 2))
    w = trace.traced(lambda i: None, 2, INFO, counters=lambda: next(counter),
                     agree=lambda whole: False)  # another rank lost some
    assert w.lost == (2, 2)
    counter = iter(range(0, 100, 2))
    w = trace.traced(lambda i: None, 2, INFO, counters=lambda: next(counter))
    assert w.lost is None
