"""BENCHMARK.json and the data files it names: every cell, configuration,
mix, limit and metric reader loads and agrees with the others, and a new
one is found by its name alone."""

import json
import re
import shutil

import pytest

from benchmark.harness import program, spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = CELLS + METRICS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (
                m["name"], cell)
    for cell in CELLS:
        c = spec.load_cell(cell)
        assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c.limits and all(v > 0 for v in c.limits.values())
    spec.loop_module(c.traffic["loop"])
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for mode in c.config["paths"]:
        cfg = program.program_config(c.config, mode)
        assert cfg.model.image_size == c.config["image_size"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_reader_loads(metric):
    assert callable(spec.metric_reader(metric))


def test_a_new_cell_is_found_by_name(tmp_path):
    """A cell, a mix, its limits and a metric added as files and entries
    alone, in a copy of the checkout."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / "benchmark"
    (here / "traffic" / "serve_b8_800.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "serve_b16_800.json")
                        .read_text()), batch=8)))
    (here / "limits" / "lhx_serve_b8.json").write_text(
        (here / "limits" / "lhx_serve_b16.json").read_text())
    (here / "metrics" / "window_ms.serve.py").write_text(
        "def read(window):\n    return window.window_s * 1e3\n")
    bench["workloads"].append({"name": "lhx_serve_b8",
                               "config": "lighthead_xception",
                               "traffic": "serve_b8_800", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "window_ms.serve", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "detect_images_per_s",
                               "workloads": ["lhx_serve_b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("lhx_serve_b8", bench=tmp_path / "BENCHMARK.json",
                          here=here)
    assert cell.traffic["batch"] == 8
    assert cell.config["preset"] == "lighthead_xception"
    assert [m["name"] for m in cell.per_layer] == ["window_ms.serve"]

    class Window:
        window_s = 0.25
    read = spec.metric_reader("window_ms.serve", here=here)
    assert read(Window()) == 250.0
