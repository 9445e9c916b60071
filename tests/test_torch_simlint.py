"""The port's determinism linter (``repro_torch/simlint/``) against the JAX
package's (``src/repro/simlint/``).

Every test of ``tests/test_simlint.py`` runs here with its linter calls
answered by both packages: each ``lint_source`` and ``lint_paths`` call must
give the same findings (path, line, column, rule and message), each CLI call
the same exit code and output, and the baseline helpers the same entries.
Then the port's own contract: its CLI exit codes and ``--list-rules``, its
default scope (the port's ``core/``, ``exp/`` and ``serving/``) clean with no
finding and an empty baseline when run as ``python -m repro_torch.simlint``,
and the repo's ``simlint.toml`` and ``simlint_baseline.json``, which hold the
JAX package's scope, never read by default.
"""
import contextlib
import dataclasses
import inspect
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.simlint as R
import repro_torch.simlint as T
import test_simlint as SL
from repro.simlint.checker import lint_paths as ref_lint_paths
from repro_torch.simlint import config as tconfig

ROOT = Path(__file__).resolve().parents[1]


def _key(findings):
    return [(f.path, f.line, f.col, f.rule, f.message) for f in findings]


def _port_cfg(cfg):
    return None if cfg is None else T.SimlintConfig(**dataclasses.asdict(cfg))


def _both_lint_source(path, text, cfg=None):
    want = R.lint_source(path, text, cfg)
    got = T.lint_source(path, text, _port_cfg(cfg))
    assert _key(got) == _key(want)
    return want


def _both_lint_paths(paths, cfg=None):
    want = ref_lint_paths(paths, cfg)
    got = T.lint_paths(paths, _port_cfg(cfg))
    assert _key(got) == _key(want)
    return want


def _both_main(argv=None):
    """Both CLIs on the same arguments and working directory: the same exit
    code and output, up to the seeding module SL002's hint names (the JAX
    package's output is printed again for the case's own checks)."""
    outs = []
    for main in (R.main, T.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(None if argv is None else list(argv))
        outs.append((rc, buf.getvalue().replace("repro_torch.exp.seeding",
                                                "repro.exp.seeding")))
    assert outs[1] == outs[0]
    print(outs[0][1], end="")
    return outs[0][0]


def _both_write_baseline(path, findings, root="."):
    want = R.write_baseline(path, findings, root=root)
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    assert T.write_baseline(path, findings, root=root) == want
    with open(path, encoding="utf-8") as fh:
        assert fh.read() == text
    return want


def _both_load_baseline(path):
    want = R.load_baseline(path)
    assert T.load_baseline(path) == want
    return want


def _both_split_new(findings, baseline, root="."):
    want = R.split_new(findings, baseline, root=root)
    got = T.split_new(findings, baseline, root=root)
    assert [_key(x) for x in got] == [_key(x) for x in want]
    return want


CASES = sorted(n for n, f in vars(SL).items() if n.startswith("test_") and callable(f))


@pytest.mark.parametrize("name", CASES)
def test_simlint_case_gives_the_same_findings(name, monkeypatch, tmp_path, capsys):
    """One test of tests/test_simlint.py, every linter call answered by both
    packages and required equal."""
    monkeypatch.setattr(SL, "lint_source", _both_lint_source)
    monkeypatch.setattr(SL, "main", _both_main)
    monkeypatch.setattr(SL, "write_baseline", _both_write_baseline)
    monkeypatch.setattr(SL, "load_baseline", _both_load_baseline)
    monkeypatch.setattr(SL, "split_new", _both_split_new)
    monkeypatch.setattr(R, "lint_paths", _both_lint_paths)  # imported inside a case
    fn = getattr(SL, name)
    fixtures = {"tmp_path": tmp_path, "capsys": capsys}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


def test_every_case_calls_a_linter():
    """The cases above reach the linters through the names they patch."""
    src = inspect.getsource(SL)
    for name in CASES:
        body = inspect.getsource(getattr(SL, name))
        assert any(call in body for call in ("_lint(", "lint_source(", "main(",
                                             "lint_paths(", "split_new(")), name
    assert "from repro.simlint import lint_paths" in src


def test_rules_are_the_jax_package_s():
    assert list(T.RULES) == list(R.RULES) == [f"SL00{i}" for i in range(1, 8)]
    for rid, rule in T.RULES.items():
        assert rule.title == R.RULES[rid].title
        assert rule.hint == R.RULES[rid].hint.replace("repro.exp.seeding",
                                                      "repro_torch.exp.seeding")


# -- the port's CLI ------------------------------------------------------------

def _tmp_repo(tmp_path, bad_lines, name="simlint_torch.toml"):
    (tmp_path / name).write_text(
        '[simlint]\npaths = ["pkg"]\nbaseline = "simlint_torch_baseline.json"\n')
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("import time\n" + "\n".join(bad_lines) + "\n")
    return tmp_path


def test_cli_exit_codes(tmp_path, capsys):
    repo = _tmp_repo(tmp_path, ["t0 = time.time()"])
    toml = str(repo / "simlint_torch.toml")
    assert T.main(["--config", toml, "--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert "pkg/mod.py:2:6: SL001" in out and "1 new finding(s)" in out
    assert T.main(["--config", toml, "--write-baseline"]) == 0
    assert (repo / "simlint_torch_baseline.json").exists()
    assert T.main(["--config", toml]) == 0
    assert "clean (1 baselined)" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        T.main(["--no-such-flag"])
    assert exc.value.code == 2


def test_cli_list_rules(capsys):
    assert T.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid, rule in T.RULES.items():
        assert f"{rid}  {rule.title}" in out


def test_module_entry_point_lints_the_port_clean():
    """``python -m repro_torch.simlint`` with its defaults, from the repo's
    root, on the port's sim path: exit 0, no finding, nothing baselined, and
    the same with the baseline ignored."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for extra in ([], ["--no-baseline"]):
        out = subprocess.run([sys.executable, "-m", "repro_torch.simlint", *extra],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.strip() == "simlint: clean"


def test_default_scope_is_the_port_s_sim_path():
    cfg = T.load_config(start=str(ROOT))
    assert cfg.paths == ("src/repro_torch/core", "src/repro_torch/exp",
                         "src/repro_torch/serving")
    assert cfg.root == str(ROOT)
    files = T.collect_files([os.path.join(cfg.root, p) for p in cfg.paths], cfg)
    assert "src/repro_torch/serving/stacks.py" in files
    assert "src/repro_torch/core/dataplane.py" in files
    assert all(f.startswith(cfg.paths) for f in files)
    assert T.lint_paths([os.path.join(cfg.root, p) for p in cfg.paths], cfg) == []
    assert not T.load_baseline(os.path.join(cfg.root, cfg.baseline))
    # a broader path keeps the training and model code out, as the JAX
    # package's excludes do
    wide = T.collect_files([str(ROOT / "src" / "repro_torch")], cfg)
    assert not [f for f in wide if f.startswith(("src/repro_torch/kernels/",
                                                 "src/repro_torch/models/",
                                                 "src/repro_torch/optim/",
                                                 "src/repro_torch/simlint/"))]
    assert "src/repro_torch/convert.py" not in wide
    assert T.lint_paths([str(ROOT / "src" / "repro_torch")], cfg) == []


def test_the_wall_clock_feed_is_suppressed_as_the_jax_package_s_is():
    """The port's dataplane reads the wall clock where the JAX package's
    does, each read suppressed inline with the JAX package's reason."""
    path = ROOT / "src" / "repro_torch" / "core" / "dataplane.py"
    text = path.read_text()
    bare = text.replace("  # simlint: disable=SL001 -- wall-clock feed mode", "")
    found = T.lint_source("dataplane.py", bare)
    assert [f.rule for f in found] == ["SL001"] * 9
    assert T.lint_source("dataplane.py", text) == []
    ref = (ROOT / "src" / "repro" / "core" / "dataplane.py").read_text()
    assert ref.count("# simlint: disable=SL001 -- wall-clock feed mode") == 9


def test_the_repo_s_simlint_toml_is_never_read_by_default(tmp_path, monkeypatch):
    assert (ROOT / "simlint.toml").exists()
    assert tconfig.load_config(start=str(ROOT)) == T.SimlintConfig(root=str(ROOT))
    assert tconfig.BASELINE_FILENAME != "simlint_baseline.json"
    # a simlint.toml naming a package with a finding: the JAX package's
    # linter reads it and fails, the port's takes its defaults and is clean
    repo = _tmp_repo(tmp_path, ["t0 = time.time()"], name="simlint.toml")
    monkeypatch.chdir(repo)
    assert R.main(["--no-hints"]) == 1
    assert T.main(["--no-hints"]) == 0
    # named explicitly, it is read
    assert T.main(["--config", str(repo / "simlint.toml"), "--no-hints"]) == 1
    # no file is discovered, whatever its name, here or in a directory above
    (repo / "simlint_torch.toml").write_text((repo / "simlint.toml").read_text())
    assert T.main(["--no-hints"]) == 0
    child = repo / "child"
    child.mkdir()
    monkeypatch.chdir(child)
    assert T.main(["--no-hints"]) == 0


_SEEN = None  # the paths the audit hook records while a test collects them


def _from_gettext():
    """Whether the call comes through the standard library's gettext, which
    argparse asks for its message catalogues (Python's lookup, not the
    linter's)."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_globals.get("__name__") == "gettext":
            return True
        frame = frame.f_back
    return False


def _record(event, args):
    if (_SEEN is not None and event in ("open", "os.listdir", "os.scandir") and args
            and not _from_gettext()):
        path = args[0]
        if isinstance(path, (str, bytes, os.PathLike)):
            _SEEN.append(os.path.abspath(os.fsdecode(path)))


def test_a_default_run_looks_at_nothing_outside_the_checkout(monkeypatch, capsys):
    """``main()`` with its defaults, from the repo's root: every file it opens,
    every directory it lists (an audit hook records them) and every path it
    stats (``os.path.isfile`` and ``exists`` call ``os.stat``) lies in the
    checkout, and it reads neither the repo's simlint.toml nor its baseline."""
    global _SEEN
    sys.addaudithook(_record)  # a hook cannot be removed; it records only here
    monkeypatch.chdir(ROOT)
    stat = os.stat

    def recording_stat(path, *args, **kwargs):
        _record("open", (path,))
        return stat(path, *args, **kwargs)

    monkeypatch.setattr(os, "stat", recording_stat)
    _SEEN = []
    try:
        assert T.main(["--no-hints"]) == 0
    finally:
        seen, _SEEN = _SEEN, None
    assert "simlint: clean" in capsys.readouterr().out
    assert seen and any(p.endswith("dataplane.py") for p in seen)
    outside = [p for p in seen if not Path(p).is_relative_to(ROOT)]
    assert outside == []
    assert str(ROOT / "simlint.toml") not in seen
    assert str(ROOT / "simlint_baseline.json") not in seen


def test_jax_package_s_linter_still_passes_its_own_config():
    out = subprocess.run([sys.executable, "-m", "repro.simlint"], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads((ROOT / "simlint_baseline.json").read_text()) == []
