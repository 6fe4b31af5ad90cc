"""Finds the benchmark's parts by name: the cell's entry in
BENCHMARK.json, its file `workloads/<name>.json`, its configuration's
file `configs/<config>.json`, and each per-layer metric's reader
`metrics/<name>.py` (a module with `read(ctx)`, returning a number or
None when it finds nothing to read). A cell, a configuration or a metric
is added by adding its file and its BENCHMARK.json entry."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def entry(bench, name):
    """The `workloads` entry of cell `name`."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def cell(name):
    return _load(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name):
    return _load(os.path.join(HERE, "configs", f"{name}.json"))


def metrics_of(bench, kind, name):
    """The `end_to_end` or `per_layer` metrics that cell `name` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(name):
    """`read` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmarks.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
