"""simlint configuration: defaults and ``simlint.toml`` parsing.

Config may live in a standalone ``simlint.toml`` (a ``[simlint]`` table,
per-rule subtables like ``[simlint.sl001]``) or inside a pyproject-style
``[tool.simlint]`` table — both spellings parse to the same
:class:`SimlintConfig`.  Parsing prefers :mod:`tomllib` (Python >= 3.11)
and falls back to a minimal built-in TOML-subset reader (tables, strings,
booleans, integers, and possibly-multiline string arrays) so the linter
stays dependency-free on 3.10 CI runners.

Own copy, in the PyTorch port, of ``src/repro/simlint/config.py``: the same
plain Python, with the port's defaults. The scope is the port's sim path,
``src/repro_torch/{core,exp,serving}`` (the port has no ``benchmarks/`` of its
own), and the excludes mirror the JAX package's for the port's ``launch/``,
``runtime/``, ``models/``, ``data/``, ``checkpoint/``, ``kernels/`` and
``simlint/``. The port's ``optim/``, ``convert.py`` and ``tree.py`` are
excluded too: AdamW, the weight conversion and the pytree helpers feed
training and checkpoints, never a RunReport, so they sit with ``runtime/``
and ``models/`` outside the determinism scope. The default paths reach none
of the excluded files; the excludes act on a wider path given on the
command line (``python -m repro_torch.simlint src/repro_torch``).

Unlike the JAX package's copy, this one discovers no config file: it reads
one only where ``--config`` names it, and otherwise takes these defaults,
rooted at the working directory. So a run looks at nothing outside the
paths it lints and the baseline it names, and the repo's ``simlint.toml``
and ``simlint_baseline.json``, which hold the JAX package's scope, are
never read by default. The default baseline is
``simlint_torch_baseline.json``, a file that does not exist, which is
empty.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# the sim-path scope: the layers whose numbers feed RunReports.  launch/,
# runtime/, models/ etc. are training/deploy utilities where wall clocks are
# the point, so the default walk (and the exclude list below) leaves them out.
DEFAULT_PATHS = (
    "src/repro_torch/core",
    "src/repro_torch/exp",
    "src/repro_torch/serving",
)

DEFAULT_EXCLUDE = (
    "*/__pycache__/*",
    "src/repro_torch/launch/*",
    "src/repro_torch/runtime/*",
    "src/repro_torch/models/*",
    "src/repro_torch/data/*",
    "src/repro_torch/checkpoint/*",
    "src/repro_torch/kernels/*",
    "src/repro_torch/simlint/*",
    "src/repro_torch/optim/*",
    "src/repro_torch/convert.py",
    "src/repro_torch/tree.py",
)

# counters the telemetry layer accumulates as int64 (SL004): attribute names
# used by ThroughputMeter, LoadGen flight stats, EthDev/SwitchPort counters
DEFAULT_INT64_COUNTERS = (
    "packets", "bytes", "sent", "received", "dropped",
    "tx_frames", "rx_frames", "tx_bytes", "rx_bytes",
    "egress_drops", "egress_enqueued", "unrouted",
    "ipackets", "opackets", "imissed", "rx_nombuf",
    "integrity_errors",
)

BASELINE_FILENAME = "simlint_torch_baseline.json"


@dataclass
class SimlintConfig:
    paths: Tuple[str, ...] = DEFAULT_PATHS
    exclude: Tuple[str, ...] = DEFAULT_EXCLUDE
    # SL001: file globs where wall-clock reads are expected wholesale
    sl001_allow: Tuple[str, ...] = ()
    # SL004: int64 counter attribute names
    sl004_counters: Tuple[str, ...] = DEFAULT_INT64_COUNTERS
    baseline: str = BASELINE_FILENAME
    # directory config values resolve against (where the config file lives)
    root: str = "."


# -- minimal TOML-subset parsing ----------------------------------------------

_TABLE_RE = re.compile(r"^\[\s*([A-Za-z0-9_.\-]+)\s*\]\s*$")
_KEY_RE = re.compile(r"^([A-Za-z0-9_\-]+)\s*=\s*(.*)$")


def _strip_comment(line: str) -> str:
    """Drop a trailing ``#`` comment (quote-aware for double quotes)."""
    out = []
    in_str = False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        elif ch == "#" and not in_str:
            break
        out.append(ch)
    return "".join(out).rstrip()


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    if raw.startswith("["):
        inner = raw[1:-1] if raw.endswith("]") else raw[1:]
        return [_parse_value(tok) for tok in _split_array(inner)]
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw)
    except ValueError:
        return raw


def _split_array(inner: str) -> List[str]:
    toks, cur, in_str = [], [], False
    for ch in inner:
        if ch == '"':
            in_str = not in_str
            cur.append(ch)
        elif ch == "," and not in_str:
            toks.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    toks.append("".join(cur))
    return [t.strip() for t in toks if t.strip()]


def _parse_toml_subset(text: str) -> Dict[str, Dict[str, Any]]:
    tables: Dict[str, Dict[str, Any]] = {}
    current = tables.setdefault("", {})
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).strip()
        i += 1
        if not line:
            continue
        m = _TABLE_RE.match(line)
        if m:
            current = tables.setdefault(m.group(1), {})
            continue
        m = _KEY_RE.match(line)
        if not m:
            raise ValueError(f"simlint.toml: cannot parse line: {line!r}")
        key, raw = m.group(1), m.group(2).strip()
        # multiline array: accumulate until brackets balance
        while raw.count("[") > raw.count("]") and i < len(lines):
            raw += " " + _strip_comment(lines[i]).strip()
            i += 1
        current[key] = _parse_value(raw)
    return tables


def _load_tables(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path, "rb") as fh:
        data = fh.read()
    try:
        import tomllib
        doc = tomllib.loads(data.decode("utf-8"))
        # flatten nested tables into dotted names, one level of values each
        flat: Dict[str, Dict[str, Any]] = {}

        def walk(prefix: str, tbl: Dict[str, Any]) -> None:
            plain = {k: v for k, v in tbl.items() if not isinstance(v, dict)}
            if plain or prefix:
                flat.setdefault(prefix, {}).update(plain)
            for k, v in tbl.items():
                if isinstance(v, dict):
                    walk(f"{prefix}.{k}" if prefix else k, v)

        walk("", doc)
        return flat
    except ModuleNotFoundError:
        return _parse_toml_subset(data.decode("utf-8"))


def _table(tables: Dict[str, Dict[str, Any]], *names: str) -> Dict[str, Any]:
    for name in names:
        if name in tables:
            return tables[name]
    return {}


def _tup(value: Any, default: Tuple[str, ...]) -> Tuple[str, ...]:
    if value is None:
        return default
    return tuple(str(v) for v in value)


def load_config(path: Optional[str] = None,
                start: str = ".") -> SimlintConfig:
    """Load config from ``path``; no path → pure defaults rooted at
    ``start``."""
    if path is None:
        return SimlintConfig(root=os.path.abspath(start))
    tables = _load_tables(path)
    top = _table(tables, "simlint", "tool.simlint")
    sl001 = _table(tables, "simlint.sl001", "tool.simlint.sl001")
    sl004 = _table(tables, "simlint.sl004", "tool.simlint.sl004")
    return SimlintConfig(
        paths=_tup(top.get("paths"), DEFAULT_PATHS),
        exclude=_tup(top.get("exclude"), DEFAULT_EXCLUDE),
        sl001_allow=_tup(sl001.get("allow"), ()),
        sl004_counters=_tup(sl004.get("counters"), DEFAULT_INT64_COUNTERS),
        baseline=str(top.get("baseline", BASELINE_FILENAME)),
        root=os.path.dirname(os.path.abspath(path)),
    )
