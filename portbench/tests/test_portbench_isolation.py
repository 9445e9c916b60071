"""Nothing under portbench imports JAX or the JAX package, or reads the JAX
package's benchmarks; the reference imports nothing of the program; a run
refuses to report where JAX was loaded or where only the benchmark's files
are present. Module names are compared whole, by their top-level part:
``repro_torch`` is the program, ``repro`` the JAX package."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH.rglob("*.py"))
RUN_SOURCES = [p for p in SOURCES if "tests" not in p.relative_to(BENCH).parts]


def imported(path: Path) -> set:
    """Top-level names of every module a file imports (relative imports
    stay inside portbench)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(arg.value.split(".")[0])
    return out


def strings(path: Path) -> list:
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", RUN_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_of_jax_named_and_no_jax_benchmarks_read(path):
    for s in strings(path):   # a dotted module path of JAX or its package, named to load
        assert not ("." in s and " " not in s and s.split(".")[0] in FORBIDDEN), s
        assert "benchmarks/" not in s and not s.startswith("benchmarks")


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch", "portbench"})
    assert "repro_torch" not in path.read_text()


def test_top_level_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    monkeypatch.setitem(sys.modules, "repro_torch_fake.x", object())
    assert run.forbidden_modules() == sorted(
        {n.split(".")[0] for n in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"repro", "jaxlib"} <= set(run.forbidden_modules())


def test_a_run_with_only_the_benchmarks_files_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    name = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                           str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
