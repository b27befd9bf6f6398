"""The port's profiling utilities (``utils/profiling.py``) on the CPU:
``trace`` writes a Chrome trace of what ran inside it, and ``DeviceTimer``
gives the mean seconds a call over distinct argument sets."""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from x_detector_tpu_torch.utils import profiling  # noqa: E402


def test_trace_writes_a_chrome_trace_of_the_body(tmp_path):
    logdir = str(tmp_path / "trace")
    a = torch.ones(64, 64)
    with profiling.trace(logdir) as prof:
        (a @ a).sum()
    path = os.path.join(logdir, profiling.TRACE_FILE)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    assert any(e.key in ("aten::mm", "aten::matmul")
               for e in prof.key_averages())


def test_device_timer_cycles_argsets_and_measures_the_mean():
    """Warm-up calls cycle the argument sets; measure(n) makes n more calls
    and returns their mean wall time, at least each call's sleep."""
    seen = []

    def fn(x):
        seen.append(int(x))
        time.sleep(0.002)
        return x

    timer = profiling.DeviceTimer(fn, [(torch.tensor(0),),
                                       (torch.tensor(1),)], warmup=3)
    assert seen == [0, 1, 0]
    mean = timer.measure(4)
    assert seen[3:] == [0, 1, 0, 1]
    assert 0.002 <= mean < 0.5


def test_device_timer_needs_an_argset():
    with pytest.raises(ValueError, match="argument set"):
        profiling.DeviceTimer(lambda: None, [])
