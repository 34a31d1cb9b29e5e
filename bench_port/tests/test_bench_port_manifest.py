"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from bench_port import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    assert manifest["paths"] == ["bench_port"]
    assert all(not w.startswith("/") and ".." not in w
               for w in manifest["command"])
    size = len(json.dumps(manifest))
    assert size <= 64 * 1024


def test_names_and_units(manifest):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for group in groups:
        names = [x["name"] for x in manifest[group]]
        assert len(names) == len(set(names)), group
        for x in manifest[group]:
            assert NAME.match(x["name"]), x["name"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    metric_names = [m["name"] for m in manifest["end_to_end"]
                    + manifest["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_end_to_end(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_every_cell_reports_enough(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for cell in cells:
        e2e = harness.metrics_of(cell, manifest, trace=False)
        assert "setup_s" in {m["name"] for m in e2e}
        assert len(e2e) >= 2
        assert harness.metrics_of(cell, manifest, trace=True)


def test_per_layer_moves_a_metric_of_its_cells(manifest):
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        e2e = {x["name"]: x for x in manifest["end_to_end"]}
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in
                                        manifest["workloads"]]):
            reported = {x["name"] for x in
                        harness.metrics_of(cell, manifest, trace=False)}
            assert m["moves"] in reported, (m["name"], cell)


def test_configs_and_cells(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in manifest["configs"]:
        assert c["file"] == f"bench_port/configs/{c['name']}.json"
        cfg = json.loads((harness.REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200
    for w in manifest["workloads"]:
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(manifest, kind):
    for m in manifest[kind]:
        assert callable(harness.reader(m["name"]))


def test_every_cell_loads_with_its_limits(manifest):
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"], manifest)
        assert cell.traffic["config"] == w["config"]
        assert cell.traffic["limits"]
        assert all(v > 0 for v in cell.traffic["limits"].values())
