"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, or holds a string that
names one of their modules (a module path handed to ``import_module`` by a
variable, as the partitioned engine's worker builder is), no module reads
the JAX package's implementation switch, and the attention entry points pick
their path from the tensor's device only."""
import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.JoinedStr)):
            head = node.args[0].values[0]
            if isinstance(head, ast.Constant):
                yield str(head.value)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


MODULE_PATH = re.compile(r"[A-Za-z_]\w*(\.[A-Za-z_]\w*)*")


def _docstring_nodes(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                yield first.value


def _module_path_strings(path: Path):
    """Every string constant, docstrings aside, that is a whole dotted
    module path."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n) for n in _docstring_nodes(tree)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs and MODULE_PATH.fullmatch(node.value)):
            yield node.value


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for need in ("chip_smoke.py", "src/repro_torch/kernels/ops.py",
                 "src/repro_torch/launch/serve.py", "src/repro_torch/convert.py"):
        assert need in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.models import lm\n"
                   "from repro_torch.models import lm as ok\n"
                   "import importlib\nimportlib.import_module('repro.kernels.ops')\n")
    assert [m for m in _imported_modules(src) if _forbidden(m)] == [
        "jax.numpy", "repro.models", "repro.kernels.ops"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_module_path_strings(path):
    bad = [m for m in _module_path_strings(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} names the modules {bad}"


def test_the_check_catches_module_path_strings(tmp_path):
    src = tmp_path / "m.py"
    src.write_text('"""Copied from repro.exp.topology."""\n'
                   'BUILDER = ("repro.exp.topology", "build")\n'
                   'OK = ("repro_torch.exp.topology", "build")\n'
                   'def f():\n    """jax.numpy"""\n    return ["jaxlib", "jax.lax", "a repro.x b"]\n')
    assert [m for m in _module_path_strings(src) if _forbidden(m)] == [
        "repro.exp.topology", "jaxlib", "jax.lax"]


def test_partition_workers_import_the_port():
    from repro_torch.exp import topology
    assert topology.PARTITION_BUILDER == ("repro_torch.exp.topology",
                                          "build_partition_domains_subset")
    assert callable(getattr(topology, topology.PARTITION_BUILDER[1]))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_impl_override_switch(path):
    assert "REPRO_FORCE_IMPL" not in path.read_text()


def test_ops_raise_on_meta_tensors():
    from repro_torch.kernels import ops
    q = torch.empty(1, 8, 2, 16, device="meta")
    k = torch.empty(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="meta"):
        ops.decode_attention(q[:, 0], k, k, torch.empty(1, dtype=torch.int32,
                                                       device="meta"))
