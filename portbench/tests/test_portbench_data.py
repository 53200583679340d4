"""The benchmark's files load by name, agree with ``BENCHMARK.json`` and
keep to its contract's shape; a cell added as files alone loads."""
import json
import os
import re
import shutil

import pytest

from conftest import ROOT, all_workloads, bench, bench_all, workloads
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = ([c["name"] for c in b["configs"]] + workloads()
             + [m["name"] for m in metrics])
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", all_workloads())
def test_cell_loads_by_name(workload):
    spec = harness.cell_spec(bench_all(), workload)
    assert spec.cfg["name"] == spec.cell["config"]
    assert spec.traffic["name"] == spec.cell["traffic"]
    names = {m["name"] for m, _ in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert {m["moves"] for m, _ in spec.per_layer} <= names
    assert spec.per_layer
    assert all(k in ("diff_share", "max_diff", "mask_diff")
               for k in spec.limits)


def test_metric_readers_agree_with_benchmark():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        reader = harness.load_reader([harness.HERE], m["name"])
        assert reader.UNIT == m["unit"] and reader.SOURCE == m["source"]
        assert reader.BETTER == m["better"]
        if "layer" in m:
            assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]


def test_per_layer_metrics_listed_where_their_moves_is_reported():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_a_cell_added_as_files_alone_loads(tmp_path):
    """A new configuration, traffic mix, metric and limits, each a new
    file in another directory, make a cell the harness finds by name."""
    for kind in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / kind).mkdir()
    cfg = json.load(open(os.path.join(harness.HERE, "configs",
                                      "lerf-g.json")))
    cfg["name"] = "lerf-g-cells"
    cfg["table_layout"] = "cells"
    json.dump(cfg, open(tmp_path / "configs" / "lerf-g-cells.json", "w"))
    traffic = json.load(open(os.path.join(harness.HERE, "traffic",
                                          "video-1080p-x2.json")))
    traffic.update(name="video-540p-x2", frame_hw=[540, 960])
    json.dump(traffic, open(tmp_path / "traffic" / "video-540p-x2.json",
                            "w"))
    (tmp_path / "metrics" / "frames_done.py").write_text(
        'LAYER = "stream"\nUNIT = "count"\nSOURCE = "host_clock"\n'
        'BETTER = "higher"\nMOVES = "out_mps"\n\n\n'
        'def read(ctx):\n    return ctx.frames_done\n')
    shutil.copy(os.path.join(harness.HERE, "limits",
                             "lerf-g.video-1080p-x2.json"),
                tmp_path / "limits" / "lerf-g-cells.video-540p-x2.json")
    b = bench()
    name = "lerf-g-cells.video-540p-x2"
    b["workloads"].append({"name": name, "config": "lerf-g-cells",
                           "traffic": "video-540p-x2", "chips": 1,
                           "why": "a test's cell"})
    b["per_layer"].append({"name": "frames_done", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "stream", "moves": "out_mps",
                           "workloads": [name]})
    spec = harness.cell_spec(b, name, dirs=(str(tmp_path), harness.HERE))
    assert spec.cfg["table_layout"] == "cells"
    assert spec.traffic["frame_hw"] == [540, 960]
    readers = {m["name"]: r for m, r in spec.per_layer}
    assert readers["frames_done"].read(type("C", (), {"frames_done": 7})) == 7
