"""BENCHMARK.json against its schema, and the harness finding each
configuration, cell and per-layer metric by name."""

import json
import os
import re

import pytest

from benchmarks import check, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(entry):
    config = registry.config(entry["name"])
    assert entry["file"] == f"benchmarks/configs/{entry['name']}.json"
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"] == []
    assert config["source"] == entry["source"]
    assert config["assumed"]
    family = registry.family(config["model"]["family"])
    assert callable(family.build) and callable(family.init_rules)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(entry):
    cell = registry.cell(entry["name"])
    assert cell["name"] == entry["name"] == entry["traffic"]
    assert cell["config"] == entry["config"] and entry["chips"] == 1
    assert cell["why"] == entry["why"] and len(entry["why"]) <= 200
    assert cell["call"] in ("graph", "eager")
    assert cell["limits"] and set(cell["limits"]) <= set(check.NUMBERS)


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(entry):
    assert callable(registry.reader(entry["name"]))
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert entry["layer"] in layers


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_reports_what_its_metrics_move(entry):
    """Every cell reports `setup_s`, another end-to-end metric and a
    per-layer one, and each per-layer metric it reports moves an
    end-to-end metric that it reports; `workloads` names only cells."""
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    name = entry["name"]
    e2e = {m["name"] for m in registry.metrics_of(BENCH, "end_to_end", name)}
    layer = registry.metrics_of(BENCH, "per_layer", name)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer), name


def test_every_file_is_named():
    """Every configuration, cell and metric file has its entry."""
    here = os.path.dirname(registry.HERE + "/")
    for sub, key in (("configs", "configs"), ("workloads", "workloads"),
                     ("metrics", "per_layer")):
        files = {os.path.splitext(f)[0] for f in
                 os.listdir(os.path.join(here, sub))
                 if f.endswith((".json", ".py"))}
        assert files == {x["name"] for x in BENCH[key]}, sub
