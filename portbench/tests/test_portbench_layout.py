"""The harness finds every configuration, traffic mix, cell, limit and
metric reader by its name, and BENCHMARK.json keeps to the shape the
benchmark's specification gives it."""
import json
import re

import pytest

from portbench import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")


def test_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"train_tokens_per_s", "peak_mem_gb", "setup_s"} <= names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["batch"] > 0 and cell.traffic["checked_steps"] == 3
    assert cell.limits and set(cell.limits) <= set(harness.NUMBERS)
    assert all(v > 0 for v in cell.limits.values())
    # the configuration's file names every weight the reference expects
    for path, _, _ in cell.specs():
        from portbench.weights import rule_for
        rule_for(path, cell.config["init"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_match_their_entries(metric):
    reader = harness.metric_reader(metric["name"])
    assert reader.LAYER == metric["layer"]
    assert reader.UNIT == metric["unit"]
    # a metric split by cells (``mfu.vlm``) shares its base's reader and
    # moves the end-to-end metric of the same split
    assert metric["moves"] == reader.MOVES or ("." in metric["name"] and
        metric["moves"] == f"{reader.MOVES}.{metric['name'].split('.')[1]}")
    assert set(metric["workloads"]) <= set(CELLS)
    # every cell it is read in reports the metric it moves
    moves = next(m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moves.get("workloads", CELLS))


def test_each_config_is_used_and_has_its_own_file():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        with open(harness.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
