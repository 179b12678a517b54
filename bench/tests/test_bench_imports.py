"""What the benchmark loads, and how it ends without a card (CPU).

Every cell's modules (the parked cells' too) loaded in a fresh process leave no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX
package; names compared whole, so ``repro_torch`` is the program); the
references import nothing of the program; ``bench/run.py`` exits non-zero
and prints no result without a card, and without the program."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

LOAD_EVERYTHING = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from bench import harness, trace, roofline, gen
spec = harness.parked_spec()
for w in spec["workloads"]:
    cell = harness.Cell.load(w["name"], spec)
    drivers, metrics = harness.BENCH / "drivers", harness.BENCH / "metrics"
    harness.load_module(drivers / (cell.traffic["driver"] + ".py"))
    for m in cell.end_to_end + cell.per_layer:
        harness.load_module(metrics / (m["name"].split(".")[0] + ".py"))
import repro_torch.train, repro_torch.models.lm, repro_torch.models.gnn
print(json.dumps(harness.forbidden_modules(sys.modules)))
"""


def test_forbidden_names_are_compared_whole():
    mods = ["repro_torch", "repro_torch.models", "reprox", "jax.numpy",
            "repro", "repro.core", "flax", "jaxlib.xla_client", "numpy"]
    assert harness.forbidden_modules(mods) == [
        "flax", "jax.numpy", "jaxlib.xla_client", "repro", "repro.core"]


def test_loading_every_cell_loads_no_jax():
    code = LOAD_EVERYTHING.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert not _imports(path) & {"repro_torch", "repro", "jax", "bench"}, \
            path.name


def test_no_bench_module_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"repro", "jax", "jaxlib", "flax"}, path


def test_run_exits_without_a_card_and_prints_nothing():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "sage-reddit2.infer", "--seed", "3", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and bench/: the harness cannot
    load the program (its look for a card skipped)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    code = ("import sys, time, torch; sys.path[:0] = ['.', 'src']\n"
            "from bench import harness\n"
            "cell = harness.Cell.load('sage-reddit2.infer')\n"
            "cell.config.update(num_nodes=100, num_edges=1000)\n"
            "print(harness.run_cell(torch, cell, 1, 0.1, False,"
            " torch.device('cpu'), time.perf_counter()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
