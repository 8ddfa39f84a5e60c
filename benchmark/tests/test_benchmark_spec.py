"""BENCHMARK.json and the files it names keep to the benchmark's contract:
every configuration, cell, traffic runner and metric reader is found by
name, and every name and unit uses only the allowed characters."""

import json
import os
import re

import pytest

from benchmark import spec

BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "-m", "benchmark.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_names_units_and_lines(group, entry):
    assert spec.NAME.match(entry["name"])
    if "unit" in entry:
        assert spec.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry and group != "end_to_end":
            assert LINE.match(entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert spec.NAME.match(entry[key])


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_load(conf):
    cfg = spec.load_json(os.path.join(spec.ROOT, conf["file"]))
    assert conf["file"].startswith("benchmark/configs/")
    assert cfg["reduced"] == conf["reduced"] == []
    assert cfg["source"] == conf["source"]
    for group in ("env", "model", "train", "assumed"):
        assert isinstance(cfg[group], dict)
    # published widths
    assert cfg["model"]["num_fc"] == 64 and cfg["model"]["num_lstm"] == 64
    assert cfg["model"]["batch_size"] == 120


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_load_with_runners_and_readers(work):
    cell = spec.load_cell(work["name"])
    assert cell.chips in (1, 4)
    spec.traffic_runner(cell.kind)
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in names


def test_every_metric_lists_its_cells_and_bounds():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_files_under_paths_are_named_from_name_characters():
    for base, _, files in os.walk(os.path.join(spec.ROOT, "benchmark")):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), spec.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_workload_files_agree_with_benchmark_json():
    for w in BENCH["workloads"]:
        work = spec.load_json(os.path.join(spec.HERE, "workloads",
                                           f"{w['name']}.json"))
        assert work["config"] == w["config"] and work["chips"] == w["chips"]
    json.dumps(BENCH)
