"""The readers of the program's own spans (``harness/program_spans.py``)
on a canned profiler trace whose answers are known by hand: idle time
inside spans, a backward launched from a second thread, counts, and
nothing read where the span is absent or the window lost kernels."""

import json

import pytest

from benchmark.harness import program_spans, spec, trace
from test_bench_readers import EXPECTED as HOOK_EXPECTED
from test_bench_readers import INFO, canned_events, ev

PROGRAM_METRICS = ["proposals_idle_ms.serve", "nms_tail_idle_ms.serve",
                   "nms_host_checks_per_batch.serve",
                   "proposals_idle_ms.train", "augment_idle_ms.train",
                   "loss_idle_ms.train", "backward_device_ms.train",
                   "optimizer_idle_ms.train"]


def events():
    """A window of 2 units (1000 us). On the card: 100-200, 250-300,
    420-480 and 450-520 (overlapping), 700-760, 900-950. Thread 1 holds
    two proposal spans (80-300 and 850-1000) with three host checks, the
    backward (400-600) and the loss (600-650); thread 2, autograd's, makes
    the launches at 410 and 430 inside the backward and one at 690 after
    it; thread 3 holds a loss span of its own, which no reader counts."""
    return [
        ev("user_annotation", "bench/window", 0, 1000),
        ev("user_annotation", "xd/proposals", 80, 220),
        ev("user_annotation", "xd/nms.host_check", 120, 10),
        ev("user_annotation", "xd/nms.host_check", 200, 10),
        ev("user_annotation", "xd/backward", 400, 200),
        ev("user_annotation", "xd/loss", 600, 50),
        ev("user_annotation", "xd/proposals", 850, 150),
        ev("user_annotation", "xd/nms.host_check", 900, 10),
        ev("user_annotation", "xd/loss", 0, 1000, tid=3),
        ev("cuda_runtime", "cudaLaunchKernel", 90, 5, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 240, 5, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 410, 5, tid=2, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 430, 5, tid=2, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 690, 5, tid=2, corr=5),
        ev("cuda_runtime", "cudaLaunchKernel", 890, 5, corr=6),
        ev("kernel", "a", 100, 100, tid=7, corr=1),
        ev("kernel", "b", 250, 50, tid=7, corr=2),
        ev("kernel", "c", 420, 60, tid=7, corr=3),
        ev("kernel", "d", 450, 70, tid=8, corr=4),
        ev("kernel", "e", 700, 60, tid=7, corr=5),
        ev("kernel", "f", 900, 50, tid=7, corr=6),
    ]


@pytest.fixture
def window():
    return trace.Window(events(), 2, {})


def test_intervals_are_the_main_threads(window):
    assert program_spans.intervals(window, "proposals") == [(80, 300),
                                                            (850, 1000)]
    assert program_spans.intervals(window, "loss") == [(600, 650)]
    assert program_spans.intervals(window, "augment") == []


def test_idle_inside_spans(window):
    # proposals: 220 - (100 + 50) and 150 - 50; the backward: 200 less the
    # union 420-520; the loss: nothing ran
    assert program_spans.idle_ms(window, "proposals") == pytest.approx(
        (70 + 100) * 1e-3 / 2)
    assert program_spans.idle_ms(window, "backward") == pytest.approx(
        100 * 1e-3 / 2)
    assert program_spans.idle_ms(window, "loss") == pytest.approx(
        50 * 1e-3 / 2)


def test_backward_launches_on_a_second_thread(window):
    """The kernels launched at 410 and 430 on thread 2 count (60 + 70 us,
    overlapping on the card); the one launched at 690, after the span,
    does not."""
    assert program_spans.device_ms_launched_in(
        window, "backward") == pytest.approx((60 + 70) * 1e-3 / 2)
    assert spec.metric_reader("backward_device_ms.train")(
        window) == pytest.approx((60 + 70) * 1e-3 / 2)


def test_count(window):
    assert program_spans.count(window, "nms.host_check") == 1.5
    assert spec.metric_reader("nms_host_checks_per_batch.serve")(
        window) == 1.5


def test_nothing_read_where_the_span_is_absent(window):
    for read in (program_spans.idle_ms, program_spans.count,
                 program_spans.device_ms_launched_in):
        assert read(window, "augment") is None
        assert read(window, "optimizer") is None


@pytest.mark.parametrize("metric", PROGRAM_METRICS)
def test_a_program_without_spans_reads_nothing(metric):
    """A window of a program without the spans (no ``xd/`` range) reads
    None, never 0, and does not raise."""
    w = trace.Window([e for e in events() if not e["name"].startswith("xd/")],
                     2, {})
    assert spec.metric_reader(metric)(w) is None


@pytest.mark.parametrize("metric", PROGRAM_METRICS)
def test_a_lost_window_reads_nothing(metric):
    w = trace.Window(events() + [
        ev("user_annotation", "xd/" + span, 960, 10)
        for span in ("augment", "postprocess", "optimizer")], 2, {})
    assert spec.metric_reader(metric)(w) is not None
    w.lost = (3, 4)
    assert spec.metric_reader(metric)(w) is None


def canned_with_spans():
    """The readers' canned window with the program's spans (host ranges
    alone) added: the proposal stage around the sort (busy 320-370 of
    210-390) with two host checks; in the second unit augmentation and the
    loss (idle), the backward (B1's backward, launched on thread 2), the NMS
    tail (the copy 702-708 of 690-760) and the optimizer (the all-reduce
    800-830 of 780-840)."""
    return canned_events() + [
        ev("user_annotation", "xd/proposals", 210, 180),
        ev("user_annotation", "xd/nms.host_check", 335, 10),
        ev("user_annotation", "xd/nms.host_check", 375, 10),
        ev("user_annotation", "xd/augment", 520, 40),
        ev("user_annotation", "xd/loss", 560, 40),
        ev("user_annotation", "xd/backward", 600, 60),
        ev("user_annotation", "xd/postprocess", 690, 70),
        ev("user_annotation", "xd/optimizer", 780, 60),
    ]


EXPECTED = {
    "proposals_idle_ms.serve": (180 - 50) * 1e-3 / 2,
    "proposals_idle_ms.train": (180 - 50) * 1e-3 / 2,
    "nms_host_checks_per_batch.serve": 2 / 2,
    "nms_tail_idle_ms.serve": (70 - 6) * 1e-3 / 2,
    "augment_idle_ms.train": 40e-3 / 2,
    "loss_idle_ms.train": 40e-3 / 2,
    "backward_device_ms.train": 20e-3 / 2,
    "optimizer_idle_ms.train": (60 - 30) * 1e-3 / 2,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_the_canned_window(metric):
    w = trace.Window(canned_with_spans(), 2, INFO)
    assert spec.metric_reader(metric)(w) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(HOOK_EXPECTED))
def test_spans_leave_the_other_readers_unchanged(metric):
    """The program's ranges are host ranges alone: every reader of the
    hook ranges and the device reads what it read without them."""
    w = trace.Window(canned_with_spans(), 2, INFO)
    assert spec.metric_reader(metric)(w) == pytest.approx(
        HOOK_EXPECTED[metric])


def test_every_per_layer_metric_has_a_case_here_or_with_the_hooks():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    assert set(PROGRAM_METRICS) == set(EXPECTED)
    assert names <= set(HOOK_EXPECTED) | set(EXPECTED)
