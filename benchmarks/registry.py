"""Finds the benchmark's parts by name: the cell's entry in
BENCHMARK.json, its file `workloads/<name>.json`, its configuration's
file `configs/<config>.json`, each per-layer metric's reader
`metrics/<name>.py` (a module with `read(ctx)`, returning a number or
None when it finds nothing to read), and each model family's module
`reference/families/<family>.py` (`build(config)`, `init_rules(model)`).
A cell, a configuration, a metric or a family is added by adding its file
(and, but for a family, its BENCHMARK.json entry)."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FAMILIES = os.path.join(HERE, "reference", "families")


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


def _module(path, qualname):
    spec = importlib.util.spec_from_file_location(qualname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name):
    """`read` of metrics/<name>.py."""
    return _module(os.path.join(HERE, "metrics", f"{name}.py"),
                   f"benchmarks.metrics.{name}").read


def family(name):
    """The module of model family `name`: FAMILIES/<name>.py."""
    path = os.path.join(FAMILIES, f"{name}.py")
    if not os.path.exists(path):
        raise ValueError(f"unknown model family {name!r}: no {path}")
    return _module(path, f"benchmarks.reference.families.{name}")
