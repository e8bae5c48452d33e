"""Nothing the benchmark runs loads JAX, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (compared as the whole top-level name: ``repro_torch``
is the port), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from perfbench.harness import hostenv

from conftest import ROOT

PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import perfbench.run as R
import perfbench.calibrate
from perfbench.harness import hostenv, manifest
from perfbench.harness.manifest import Cell, _json, BENCH
bench = manifest.load_manifest(R.ROOT)
for m in bench["per_layer"]:
    manifest.metric_reader(m["name"])
for w in bench["workloads"]:
    cell = manifest.load_cell(R.ROOT, w["name"])
    manifest.driver(cell.traffic["driver"])
import perfbench.reference.dqn, perfbench.reference.molopt
cfg = _json(BENCH / "configs/damoldqn-molopt.json")
tr = _json(BENCH / "traffic/closed64.json")
tr.update(slots=2, clients=2, check_sample=2, warmup_steps=1)
cell = Cell("probe", {{"chips": 1}}, cfg, tr, {{"q_gap": 1.0}},
            [{{"name": "serve_done_req_s", "unit": "req/s"}}], [])
res = R.execute(cell, 3, 0.5, False, "cpu", log=lambda *a: None)
print(sorted(hostenv.forbidden_modules()))
"""


def test_forbidden_names_are_compared_whole():
    assert hostenv.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "reproducible"]) == []
    assert hostenv.forbidden_modules(["repro.core", "jax", "flax.linen",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_this_test_process_has_not_loaded_them():
    # the folder's own pytest settings keep the repository's conftest.py
    # (which imports the JAX package) from loading
    assert hostenv.forbidden_modules() == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = ROOT / "perfbench" / "reference"
    files = sorted(ref.rglob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"repro_torch", "repro", "jax", "benchmarks"}, f


def test_the_harness_imports_nothing_of_benchmarks_or_the_jax_package():
    for f in sorted((ROOT / "perfbench").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"repro", "jax", "jaxlib", "flax", "benchmarks"}, f
