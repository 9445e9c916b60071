"""AST checkers for the SL001–SL007 determinism rules.

One parse per file feeds every rule.  Imports are resolved to dotted names
(``np.random.default_rng`` → ``numpy.random.default_rng``) so aliases cannot
dodge a rule, and suppression comments (``# simlint: disable=SL001 -- why``)
are honored per physical line.

Own copy, in the PyTorch port, of ``src/repro/simlint/checker.py``: the same
plain Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .config import SimlintConfig
from .rules import Finding

_DISABLE_RE = re.compile(r"#\s*simlint:\s*disable=([A-Za-z0-9,\s]+)")

WALL_CLOCK_CALLS = {
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

# numpy.random attributes that are explicit-seed constructors, not draws from
# the legacy global state
_SEEDED_NP_RANDOM = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "MT19937", "Philox", "SFC64",
}

_SCHED_TOKENS = ("EventScheduler", "DomainScheduler")
_MP_MODULES = ("multiprocessing", "concurrent.futures")


def parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """line number (1-based) → set of suppressed rule ids ("ALL" == any)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _DISABLE_RE.search(line)
        if m:
            ids = {tok.strip().upper() for tok in m.group(1).split(",")
                   if tok.strip()}
            if ids:
                out[i] = ids
    return out


class _ImportTable(ast.NodeVisitor):
    """local name → fully dotted origin, from import statements."""

    def __init__(self) -> None:
        self.alias: Dict[str, str] = {}
        self.modules: Set[str] = set()

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.modules.add(a.name)
            self.alias[a.asname or a.name.split(".")[0]] = \
                a.name if a.asname else a.name.split(".")[0]

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is None or node.level:
            return  # relative imports stay repo-internal
        self.modules.add(node.module)
        for a in node.names:
            self.alias[a.asname or a.name] = f"{node.module}.{a.name}"


def _dotted(node: ast.AST, alias: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Name):
        return alias.get(node.id, node.id)
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value, alias)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _is_set_expr(node: ast.AST, alias: Dict[str, str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func, alias) in ("set", "frozenset")
    return False


def _is_set_annotation(node: ast.AST, alias: Dict[str, str]) -> bool:
    target = node.value if isinstance(node, ast.Subscript) else node
    d = _dotted(target, alias)
    return d in ("set", "frozenset", "Set", "FrozenSet", "typing.Set",
                 "typing.FrozenSet")


def _is_floaty(node: ast.AST, alias: Dict[str, str]) -> bool:
    """Does this expression smell like it produces a Python float?"""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Div):
            return True
        return _is_floaty(node.left, alias) or _is_floaty(node.right, alias)
    if isinstance(node, ast.UnaryOp):
        return _is_floaty(node.operand, alias)
    if isinstance(node, ast.Call):
        d = _dotted(node.func, alias)
        return d in ("float", "numpy.mean", "numpy.average", "numpy.std",
                     "numpy.var", "numpy.float64", "numpy.float32")
    if isinstance(node, ast.IfExp):
        return _is_floaty(node.body, alias) or _is_floaty(node.orelse, alias)
    return False


def _dataclass_frozen(node: ast.ClassDef,
                      alias: Dict[str, str]) -> Optional[bool]:
    """None == not a dataclass; else whether frozen=True is declared."""
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _dotted(target, alias) in ("dataclass", "dataclasses.dataclass"):
            if isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "frozen":
                        return (isinstance(kw.value, ast.Constant)
                                and kw.value.value is True)
            return False
    return None


def _class_fields(node: ast.ClassDef) -> List[Tuple[str, ast.AnnAssign]]:
    """Dataclass fields: class-level annotated names, minus ClassVar."""
    out = []
    for stmt in node.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            ann = ast.unparse(stmt.annotation)
            if "ClassVar" in ann:
                continue
            out.append((stmt.target.id, stmt))
    return out


def _find_method(node: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    for stmt in node.body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name == name:
            return stmt
    return None


class _Checker:
    def __init__(self, path: str, text: str, tree: ast.Module,
                 cfg: SimlintConfig):
        self.path = path
        self.text = text
        self.cfg = cfg
        self.tree = tree
        self.findings: List[Finding] = []
        imports = _ImportTable()
        imports.visit(tree)
        self.alias = imports.alias
        self.sched_adjacent = any(tok in text for tok in _SCHED_TOKENS)
        self.is_mp = any(
            m == mod or m.startswith(mod + ".")
            for m in imports.modules for mod in _MP_MODULES)
        self.sl001_allowed = any(
            fnmatch.fnmatch(path, pat) for pat in cfg.sl001_allow)
        self.set_names: Set[str] = self._collect_set_names()

    def _add(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(
            path=self.path, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1, rule=rule,
            message=message))

    def _collect_set_names(self) -> Set[str]:
        """Names (incl. ``self.x``) bound to set expressions anywhere in the
        file — a deliberately scope-blind approximation."""
        names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and _is_set_expr(node.value,
                                                             self.alias):
                for tgt in node.targets:
                    d = _dotted(tgt, self.alias)
                    if d:
                        names.add(d)
            elif isinstance(node, ast.AnnAssign) and node.target is not None:
                if _is_set_annotation(node.annotation, self.alias) or (
                        node.value is not None
                        and _is_set_expr(node.value, self.alias)):
                    d = _dotted(node.target, self.alias)
                    if d:
                        names.add(d)
        return names

    def run(self) -> List[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check_call(node)
            elif isinstance(node, ast.For):
                self._check_iter(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    self._check_iter(gen.iter)
            elif isinstance(node, ast.AugAssign):
                self._check_augassign(node)
            elif isinstance(node, ast.ClassDef):
                self._check_classdef(node)
            elif isinstance(node, ast.Subscript) and self.is_mp:
                if _dotted(node.value, self.alias) == "os.environ":
                    self._add(node, "SL007",
                              "os.environ read in an mp-worker code path")
        return self.findings

    # -- SL001 / SL002 / SL007 (calls) ----------------------------------------
    def _check_call(self, node: ast.Call) -> None:
        d = _dotted(node.func, self.alias)
        if d is None:
            return
        if d in WALL_CLOCK_CALLS and not self.sl001_allowed:
            self._add(node, "SL001", f"wall-clock call {d}() in a sim path")
        elif d.startswith("numpy.random."):
            tail = d[len("numpy.random."):]
            if "." in tail:
                return  # method on e.g. numpy.random.default_rng(...)
            if tail == "default_rng":
                if not node.args:
                    self._add(node, "SL002",
                              "default_rng() without an explicit seed "
                              "draws OS entropy")
            elif tail not in _SEEDED_NP_RANDOM:
                self._add(node, "SL002",
                          f"global-state RNG call numpy.random.{tail}()")
        elif d.startswith("random.") and d.count(".") == 1:
            tail = d[len("random."):]
            if tail in ("Random", "SystemRandom"):
                if tail == "SystemRandom" or not node.args:
                    self._add(node, "SL002",
                              f"random.{tail}() without an explicit seed")
            else:
                self._add(node, "SL002",
                          f"global-state RNG call random.{tail}()")
        elif self.is_mp:
            if d == "os.getpid":
                self._add(node, "SL007",
                          "os.getpid() in an mp-worker code path")
            elif d == "os.environ.get":
                self._add(node, "SL007",
                          "os.environ read in an mp-worker code path")
            elif d == "id":
                self._add(node, "SL007",
                          "id()-derived key in an mp-worker code path is "
                          "address-dependent across processes")

    # -- SL003 -----------------------------------------------------------------
    def _check_iter(self, it: ast.AST) -> None:
        if not self.sched_adjacent:
            return
        if _is_set_expr(it, self.alias):
            self._add(it, "SL003",
                      "iteration over a set literal/constructor in "
                      "scheduler-adjacent code")
            return
        d = _dotted(it, self.alias)
        if d is not None and d in self.set_names:
            self._add(it, "SL003",
                      f"iteration over set-typed {d!r} in scheduler-"
                      "adjacent code")

    # -- SL004 -----------------------------------------------------------------
    def _check_augassign(self, node: ast.AugAssign) -> None:
        if not isinstance(node.op, ast.Add):
            return
        if not isinstance(node.target, ast.Attribute):
            return
        attr = node.target.attr
        if attr not in self.cfg.sl004_counters:
            return
        if _is_floaty(node.value, self.alias):
            self._add(node, "SL004",
                      f"float accumulation into int64 counter .{attr}")

    # -- SL005 / SL006 ---------------------------------------------------------
    def _check_classdef(self, node: ast.ClassDef) -> None:
        if not node.name.endswith("Config"):
            return
        frozen = _dataclass_frozen(node, self.alias)
        if frozen is None:
            return  # not a dataclass — out of scope
        fields = _class_fields(node)
        if not frozen:
            self._add(node, "SL005",
                      f"config dataclass {node.name} is not frozen=True")
        for name, stmt in fields:
            if stmt.value is not None and isinstance(
                    stmt.value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                 ast.DictComp, ast.SetComp)):
                self._add(stmt, "SL005",
                          f"mutable default on config field {name!r} "
                          "(use field(default_factory=...))")
        self._check_roundtrip(node, [n for n, _ in fields])

    def _check_roundtrip(self, node: ast.ClassDef,
                         fields: List[str]) -> None:
        to_dict = _find_method(node, "to_dict")
        from_dict = _find_method(node, "from_dict")
        if to_dict is None and from_dict is None:
            return
        if to_dict is None or from_dict is None:
            have, miss = (("to_dict", "from_dict") if from_dict is None
                          else ("from_dict", "to_dict"))
            self._add(node, "SL006",
                      f"{node.name} defines {have} without {miss} — the "
                      "round-trip cannot close")
            return
        fset = set(fields)
        keys = self._explicit_dict_keys(to_dict)
        if keys is not None:
            missing = sorted(fset - keys)
            extra = sorted(keys - fset)
            if missing:
                self._add(to_dict, "SL006",
                          f"{node.name}.to_dict omits field(s) "
                          f"{', '.join(missing)}")
            if extra:
                self._add(to_dict, "SL006",
                          f"{node.name}.to_dict emits non-field key(s) "
                          f"{', '.join(extra)}")
        kwargs = self._explicit_ctor_kwargs(node, from_dict)
        if kwargs is not None:
            missing = sorted(fset - kwargs)
            if missing:
                self._add(from_dict, "SL006",
                          f"{node.name}.from_dict never passes field(s) "
                          f"{', '.join(missing)}")

    @staticmethod
    def _explicit_dict_keys(fn: ast.FunctionDef) -> Optional[Set[str]]:
        """Keys of a returned dict literal, or None when to_dict is generic
        (returns a helper call / builds the dict dynamically)."""
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Return) and isinstance(stmt.value,
                                                           ast.Dict):
                keys: Set[str] = set()
                for k in stmt.value.keys:
                    if k is None:  # **spread — dynamic, trust it
                        return None
                    if not (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)):
                        return None
                    keys.add(k.value)
                return keys
        return None

    @staticmethod
    def _explicit_ctor_kwargs(node: ast.ClassDef,
                              fn: ast.FunctionDef) -> Optional[Set[str]]:
        """Keyword names of an all-explicit cls(...) construction, or None
        when from_dict forwards dynamically (cls(**d))."""
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.Call):
                continue
            callee = stmt.func
            name = callee.id if isinstance(callee, ast.Name) else None
            if name not in ("cls", node.name):
                continue
            if any(kw.arg is None for kw in stmt.keywords):
                return None  # cls(**d)
            if stmt.args:
                return None  # positional — give it the benefit of the doubt
            return {kw.arg for kw in stmt.keywords}
        return None


def lint_source(path: str, text: str,
                cfg: Optional[SimlintConfig] = None) -> List[Finding]:
    """Lint one file's source; returns unsuppressed findings in line order."""
    cfg = cfg or SimlintConfig()
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as exc:
        return [Finding(path=path, line=exc.lineno or 1, col=1, rule="SL000",
                        message=f"syntax error: {exc.msg}")]
    findings = _Checker(path, text, tree, cfg).run()
    suppressed = parse_suppressions(text.splitlines())
    out = []
    for f in findings:
        ids = suppressed.get(f.line)
        if ids is not None and (f.rule in ids or "ALL" in ids):
            continue
        out.append(f)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def _norm(path: str, root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), root)
    return rel.replace(os.sep, "/")


def collect_files(paths: Sequence[str], cfg: SimlintConfig) -> List[str]:
    """Expand files/directories into the sorted list of lintable .py files,
    honoring the config's exclude globs (paths relative to ``cfg.root``)."""
    out: Set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            out.add(_norm(p, cfg.root))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames.sort()
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.add(_norm(os.path.join(dirpath, fn), cfg.root))
    def excluded(rel: str) -> bool:
        return any(fnmatch.fnmatch(rel, pat) for pat in cfg.exclude)
    return sorted(rel for rel in out if not excluded(rel))


def lint_paths(paths: Sequence[str],
               cfg: Optional[SimlintConfig] = None) -> List[Finding]:
    """Lint every file under ``paths``; findings carry root-relative paths."""
    cfg = cfg or SimlintConfig()
    findings: List[Finding] = []
    for rel in collect_files(paths, cfg):
        full = os.path.join(cfg.root, rel)
        with open(full, "r", encoding="utf-8") as fh:
            text = fh.read()
        findings.extend(lint_source(rel, text, cfg))
    return findings
