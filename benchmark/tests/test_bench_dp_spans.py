"""The readers of the data-parallel exchange (``sync_device_ms.train``,
``sync_idle_ms.train``, and ``allreduce_device_ms``, NCCL's kernels by
name) on a canned profiler trace whose answers are known by hand, and
nothing read where the program's ``xd/sync`` span is absent or the window
lost kernels."""

import json

import pytest

from benchmark.harness import spec, trace
from test_bench_readers import ev

SYNC_METRICS = ["sync_device_ms.train", "sync_idle_ms.train"]


def events():
    """A window of 2 steps (1000 us). The backward (100-300) launches a
    kernel at 110 (150-250) and one at 290 that runs 300-308, inside the
    first exchange but launched before it. The exchange ``xd/sync`` runs
    300-400 and 800-900 on the main thread: in the first the flatten
    (launched 305, runs 310-320), NCCL's all-reduce (322: 330-370), the
    division (375: 380-385) and a copy back (390: 392-395); in the second
    the all-reduce (805: 820-880) and a copy back launched at 890 that runs
    after the span (905-915). Thread 3 holds an ``xd/sync`` of its own,
    which no reader counts."""
    return [
        ev("user_annotation", "bench/window", 0, 1000),
        ev("user_annotation", "xd/backward", 100, 200),
        ev("user_annotation", "xd/sync", 300, 100),
        ev("user_annotation", "xd/sync", 800, 100),
        ev("user_annotation", "xd/sync", 0, 1000, tid=3),
        ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 290, 5, corr=8),
        ev("cuda_runtime", "cudaLaunchKernel", 305, 3, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 322, 3, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 375, 3, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 390, 3, corr=5),
        ev("cuda_runtime", "cudaLaunchKernel", 805, 3, corr=6),
        ev("cuda_runtime", "cudaLaunchKernel", 890, 3, corr=7),
        ev("kernel", "conv_bwd", 150, 100, tid=7, corr=1),
        ev("kernel", "bn_bwd", 300, 8, tid=7, corr=8),
        ev("kernel", "CatArrayBatchedCopy", 310, 10, tid=7, corr=2),
        ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 330, 40,
           tid=9, corr=3),
        ev("kernel", "vectorized_elementwise_kernel_div", 380, 5, tid=7,
           corr=4),
        ev("kernel", "elementwise_copy", 392, 3, tid=7, corr=5),
        ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 820, 60,
           tid=9, corr=6),
        ev("kernel", "elementwise_copy", 905, 10, tid=7, corr=7),
    ]


EXPECTED = {
    # launched inside the spans: 10 + 40 + 5 + 3, then 60 + 10
    "sync_device_ms.train": (10 + 40 + 5 + 3 + 60 + 10) * 1e-3 / 2,
    # 100 less the busy 300-308, 310-320, 330-370, 380-385, 392-395; then
    # 100 less 820-880
    "sync_idle_ms.train": ((100 - 66) + (100 - 60)) * 1e-3 / 2,
    # NCCL's kernels by name, wherever launched
    "allreduce_device_ms": (40 + 60) * 1e-3 / 2,
}


@pytest.fixture
def window(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events()}))
    return trace.Window(trace._events(str(path)), 2, {})


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_the_canned_window(window, metric):
    assert spec.metric_reader(metric)(window) == pytest.approx(
        EXPECTED[metric])


@pytest.mark.parametrize("metric", SYNC_METRICS)
def test_a_program_without_the_span_reads_nothing(metric):
    """The parent of the span: its window reads None, never 0, and does
    not raise; NCCL's kernels still read."""
    w = trace.Window([e for e in events() if e["name"] != "xd/sync"], 2, {})
    assert spec.metric_reader(metric)(w) is None
    assert spec.metric_reader("allreduce_device_ms")(w) == pytest.approx(
        EXPECTED["allreduce_device_ms"])


@pytest.mark.parametrize("metric", SYNC_METRICS)
def test_a_lost_window_reads_nothing(window, metric):
    assert spec.metric_reader(metric)(window) is not None
    window.lost = (3, 4)
    assert spec.metric_reader(metric)(window) is None


def test_one_card_reads_no_all_reduce():
    """A window with no NCCL kernel (a one-card step) reads None."""
    w = trace.Window([e for e in events() if "nccl" not in e["name"]], 2,
                     {})
    assert spec.metric_reader("allreduce_device_ms")(w) is None

