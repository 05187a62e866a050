"""Files found by name, and ``BENCHMARK.json`` against them and the
contract's shape."""
import json
import re

import pytest

from graphbench import bench, datasets

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_new_config_and_traffic_found_by_name(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "configs" / "new-graph.json").write_text(json.dumps({"generator": "subgen"}))
    (tmp_path / "traffic" / "bursty.json").write_text(json.dumps({"arrivals": "poisson"}))
    assert bench.load_config("new-graph", base=tmp_path)["name"] == "new-graph"
    assert bench.load_traffic("bursty", base=tmp_path)["arrivals"] == "poisson"
    with pytest.raises(FileNotFoundError):
        bench.load_config("absent", base=tmp_path)
    with pytest.raises(ValueError):
        bench.load_traffic("../configs/new-graph", base=tmp_path)


def test_metric_found_by_family():
    read = bench.metric_reader("loads_per_query.some_new_cell_family")
    assert read is bench.metric_reader("loads_per_query.stream")
    with pytest.raises(FileNotFoundError):
        bench.metric_reader("no_such_metric.stream")


def test_benchmark_json_resolves():
    b = bench.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["graphbench"] and b["command"][1] == "graphbench/run.py"
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    for c in b["configs"]:
        assert c["file"] == f"graphbench/configs/{c['name']}.json"
        cfg = bench.load_config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        gen = datasets.generator(cfg["generator"])
        assert set(cfg["queries"]) <= set(gen.TEMPLATES)
    for w in b["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        bench.load_traffic(w["traffic"])
        assert len(w["why"]) <= 200
    ends = {m["name"]: m for m in b["end_to_end"]}
    assert ends["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["per_layer"]:
        bench.metric_reader(m["name"])
        # every cell that reports it reports the metric it moves
        moved = ends[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        got = [m["name"] for m in bench.cell_metrics(b, cell, "end_to_end")]
        assert "setup_s" in got and len(got) >= 2
        assert bench.cell_metrics(b, cell, "per_layer")
    assert len(json.dumps(b)) < 64 * 1024
