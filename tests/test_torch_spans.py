"""The port's program spans (``utils/profiling.span``) on the CPU with a
tiny Light-Head: none with the profiler off, each stage's span once a
batch, step or microbatch under ``torch.profiler``, NMS's host checks
counted as the program counts them, the spans nested inside the
benchmark's hook ranges, and no span in an exported program."""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmark.harness import program_spans, trace  # noqa: E402
from benchmark.harness.spans import Spans  # noqa: E402
from benchmark.harness.spec import HERE  # noqa: E402
from x_detector_tpu_torch import config as C  # noqa: E402
from x_detector_tpu_torch.cli import export  # noqa: E402
from x_detector_tpu_torch.data.augment import (  # noqa: E402
    preprocess_batch_for_train, preprocess_for_eval)
from x_detector_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_batch_device)
from x_detector_tpu_torch.inference import (  # noqa: E402
    ServingModule, build_eval_fn, build_model)
from x_detector_tpu_torch.ops import nms  # noqa: E402
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state, make_train_step)
from x_detector_tpu_torch.utils import profiling  # noqa: E402

SIZE = 64
# the benchmark's hook ranges around the Light-Head's modules
HOOK_SPANS = json.loads((HERE / "configs" / "lighthead_xception.json"
                         ).read_text())["spans"]


def _cfg(accum: int = 1):
    """A tiny Light-Head whose proposal NMS walks two tiles."""
    model = C.ModelConfig(
        name="tiny_lh", backbone="xception_lite", family="lighthead",
        image_size=SIZE, large_sep_mid=16, head_dim=64,
        backbone_stages=(1, 1, 1, 1), backbone_widths=(32, 64, 96, 128),
        proposals=C.ProposalConfig(pre_nms_topk=256, post_nms_topk=32,
                                   pre_nms_topk_eval=256,
                                   post_nms_topk_eval=32, min_size=2.0),
        nms=C.NMSConfig(max_output=20))
    return C.ExperimentConfig(
        model=model, data=C.DataConfig(image_size=SIZE, max_gt_boxes=8),
        train=C.TrainConfig(batch_size=2, learning_rate=1e-3,
                            warmup_steps=0, weight_decay=0.0, ohem_topk=16,
                            grad_accum_steps=accum))


@pytest.fixture(scope="module")
def serving():
    cfg = _cfg()
    model = build_model(cfg.model, "cpu", seed=0, dtype=torch.float32)
    images = preprocess_for_eval(torch.rand(2, SIZE, SIZE, 3) * 255.0,
                                 cfg.data)
    return cfg, model, build_eval_fn(model, cfg, "cpu"), images


def _training(accum: int = 1):
    cfg = _cfg(accum)
    state = create_model_and_state(cfg, "cpu", seed=0, dtype=torch.float32)
    step = make_train_step(state.model, cfg)
    gen = torch.Generator().manual_seed(0)
    raw = synthetic_batch_device(gen, 2, 80, max_gt=cfg.data.max_gt_boxes)

    def one():
        batch = preprocess_batch_for_train(gen, raw, cfg.data)
        return step(state, batch, gen)

    return one


def _profiled(run, units: int, tmp_path, model=None) -> trace.Window:
    """``run()`` ``units`` times under the CPU profiler, inside the
    benchmark's window range (and its hook ranges on ``model``), read back
    as the benchmark reads a trace."""
    hooks = Spans(model, HOOK_SPANS) if model is not None else None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(units):
                run()
    if hooks is not None:
        hooks.remove()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return trace.Window(trace._events(path), units, {})


def _spans(window: trace.Window, name: str) -> int:
    return sum(n == program_spans.PREFIX + name
               for nest in window.host.values() for n in nest.names)


def test_no_record_function_with_the_profiler_off(serving, monkeypatch):
    """With the profiler off a span opens no ``record_function``: one
    served batch and one train step run with it made to raise."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the "
                             f"profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with pytest.raises(AssertionError):
        torch.profiler.record_function("xd/check")
    _, _, detect, images = serving
    detect(images)
    one = _training()
    one()


def test_span_is_a_range_only_while_the_profiler_records():
    assert profiling.span("x") is profiling.span("y")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("x"),
                          torch.profiler.record_function)


def test_serving_spans_once_a_batch(serving, tmp_path):
    """``xd/proposals`` and ``xd/postprocess`` once a batch; the
    ``xd/nms.host_check`` ranges are the program's count of its checks,
    at least one a call of the fixpoint."""
    _, model, detect, images = serving
    calls, checks = nms.self_suppress.calls, nms.self_suppress.checks
    w = _profiled(lambda: detect(images), 3, tmp_path)
    calls = nms.self_suppress.calls - calls
    checks = nms.self_suppress.checks - checks
    assert _spans(w, "proposals") == 3 and _spans(w, "postprocess") == 3
    assert _spans(w, "nms.host_check") == checks >= calls >= 3 * 3
    assert program_spans.count(w, "nms.host_check") == checks / 3


@pytest.mark.parametrize("accum", [1, 2])
def test_training_spans_once_a_microbatch(accum, tmp_path):
    """``xd/augment`` and ``xd/optimizer`` once a step, ``xd/proposals``,
    ``xd/loss`` and ``xd/backward`` once a microbatch."""
    one = _training(accum)
    calls, checks = nms.self_suppress.calls, nms.self_suppress.checks
    w = _profiled(one, 2, tmp_path)
    checks = nms.self_suppress.checks - checks
    assert _spans(w, "augment") == _spans(w, "optimizer") == 2
    for name in ("proposals", "loss", "backward"):
        assert _spans(w, name) == 2 * accum, name
    assert _spans(w, "nms.host_check") == checks
    assert checks >= nms.self_suppress.calls - calls >= 2 * accum * 2


def _inside(span, outer) -> bool:
    return any(s <= span[0] and span[1] <= e for s, e in outer)


def test_spans_nest_inside_the_benchmarks_hook_ranges(serving, tmp_path):
    """On one thread every ``xd/`` range and every ``bench/`` hook range
    are disjoint or one holds the other; each proposal stage lies inside
    the hook range ``bench/proposals``, each host check inside a proposal
    stage or an NMS tail, and the NMS tails outside every hook range
    (after the model's forward)."""
    _, model, detect, images = serving
    w = _profiled(lambda: detect(images), 2, tmp_path, model)
    nest = w.host[w._main_tid()]
    ranges = [(s, e, n) for s, e, n in zip(nest.starts, nest.ends,
                                           nest.names)
              if n.startswith(("xd/", "bench/"))]
    for s, e, n in ranges:
        for s2, e2, n2 in ranges:
            assert e <= s2 or e2 <= s or (s <= s2 and e2 <= e) or (
                s2 <= s and e <= e2), (n, n2)

    def of(name):
        return [(s, e) for s, e, n in ranges if n == name]

    props, tails = of("xd/proposals"), of("xd/postprocess")
    assert len(props) == len(of("bench/proposals")) == len(tails) == 2
    assert all(_inside(p, of("bench/proposals")) for p in props)
    checks = of("xd/nms.host_check")
    assert checks and all(_inside(c, props + tails) for c in checks)
    hooks = [(s, e) for s, e, n in ranges
             if n.startswith("bench/") and n != trace.WINDOW]
    assert not any(_inside(t, hooks) for t in tails)


def test_export_under_the_profiler_holds_no_span(serving):
    """``torch.export`` of ``ServingModule`` while the profiler records:
    the graph holds no profiler node, and the program gives eager
    inference's detections."""
    cfg, model, detect, images = serving
    want = detect(images)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        program = export.export_program(ServingModule(model, cfg), 2, "cpu")
    targets = {str(n.target) for n in program.graph.nodes}
    assert not [t for t in targets if "profiler" in t or "record" in t]
    assert "xdt.nms_suppress.default" in targets
    with torch.inference_mode():
        got = program.module()(images)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
