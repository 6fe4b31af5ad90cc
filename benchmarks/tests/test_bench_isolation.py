"""What the benchmark loads: no JAX and nothing of the JAX package in a
run's process; nothing of the program in the reference."""

import os
import subprocess
import sys

from conftest import ROOT

BLOCKED = ("jax", "jaxlib", "flax", "optax", "ust_run_tpu")


def _fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.split()


def test_run_loads_no_jax():
    """The harness, the reference and every metric imported, and a tiny
    run driven through the port on the CPU, in a fresh process: no module
    whose top-level name is exactly one of BLOCKED (ust_run_tpu_torch
    begins with ust_run_tpu, so the names are compared whole)."""
    code = f"""
import sys, time, torch
sys.path.insert(0, {os.path.join(ROOT, 'benchmarks', 'tests')!r})
from benchmarks import run, readings, registry, counting, trace
import benchmarks.reference.step, benchmarks.reference.models
from conftest import tiny
bench = registry.benchmark()
for m in bench["per_layer"]:
    registry.reader(m["name"])
cell, config = tiny("unet_fundus.graph", eager=True)
run.run_cell(bench, "unet_fundus.graph", 3, 0.1, 0, torch.device("cpu"),
             time.time(), cell=cell, config=config)
assert "ust_run_tpu_torch.semisup.step" in sys.modules
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    tops = set(_fresh(code))
    assert "ust_run_tpu_torch" in tops
    assert not tops & set(BLOCKED), tops & set(BLOCKED)


def test_reference_loads_no_program():
    code = """
import sys, torch
import benchmarks.reference, benchmarks.reference.step
import benchmarks.reference.models, benchmarks.reference.ops
import benchmarks.reference.losses
from benchmarks import registry
for c in registry.benchmark()["configs"]:
    with torch.device("meta"):
        benchmarks.reference.models.build(registry.config(c["name"]))
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""
    tops = set(_fresh(code))
    assert "benchmarks" in tops
    assert not tops & ({"ust_run_tpu_torch"} | set(BLOCKED))


def test_reference_sources_name_no_program():
    here = os.path.join(ROOT, "benchmarks", "reference")
    for sub, _, files in os.walk(here):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(sub, f)).read()
                assert "import ust_run_tpu" not in text, f
                assert "from ust_run_tpu" not in text, f
