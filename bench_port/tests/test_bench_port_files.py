"""BENCHMARK.json against the benchmark contract, and every configuration,
traffic mix and per-layer metric it names found by name."""

import json
import re
from pathlib import Path

import pytest

from bench_port import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_have_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in BENCH[k])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(workload):
    cell = harness.Cell.load(workload)
    assert harness.load_loop(cell.traffic["loop"]).KIND in ("train", "render")
    assert cell.cfg["name"] in workload and cell.cfg["reduced"] == []
    e2e = [m["name"] for m in BENCH["end_to_end"] if workload in m.get("workloads", [workload])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    assert cell.limits, f"no limits/{workload}.json"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = harness.load_reader(metric)
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (entry["layer"], entry["unit"],
                                                         entry["moves"])
    assert callable(reader.read)


def test_a_new_loop_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A cell added as files: a loop module, a traffic mix naming it and a
    metric reader beside the existing ones are loaded by their names alone."""
    import bench_port.loops

    for d in ("traffic", "metrics", "loops"):
        (tmp_path / d).mkdir()
    (tmp_path / "loops" / "render_twice.py").write_text(
        "from bench_port.loops import render\n\n\n"
        "class Loop(render.Loop):\n"
        "    def unit(self, win):\n"
        "        super().unit(win)\n"
        "        super().unit(win)\n")
    (tmp_path / "traffic" / "render_twice_270.json").write_text(json.dumps(
        {"loop": "render_twice", "width": 480, "height": 270, "sample_views": 1,
         "isect_headroom": 1.1, "trace_units": 4}))
    (tmp_path / "metrics" / "views.render.py").write_text(
        'LAYER, UNIT, MOVES = "whole view", "views", "view_ms"\n'
        "def read(ctx):\n    return float(ctx.units)\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    monkeypatch.setattr(bench_port.loops, "__path__",
                        list(bench_port.loops.__path__) + [str(tmp_path / "loops")])
    reader = harness.load_reader("views.render")
    assert reader.read(type("C", (), {"units": 3})()) == 3.0
    mix = harness.load_json(tmp_path / "traffic" / "render_twice_270.json")
    loop = harness.load_loop(mix["loop"])
    assert loop.KIND == "render" and loop.__module__ == "bench_port.loops.render_twice"
