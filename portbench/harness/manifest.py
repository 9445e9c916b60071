"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own under ``portbench/``:

* ``configs/<config>.json``: the configuration as it is run (the entry's
  ``file``), with ``model`` (the program's config fields) and ``reference``
  (the module under ``reference/`` that computes it plainly);
* ``traffic/<traffic>.json``: the traffic mix's parameters, whose ``kind``
  names the general driver ``drivers/<kind>.py`` that runs it;
* ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``;
* ``limits/<workload>.json``: the cell's compared numbers, each with the
  limit and the readings it was set from.

A new cell, configuration, traffic mix or metric is new files and new
entries: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parents[1]          # portbench/
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")


class ManifestError(ValueError):
    pass


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: Optional[tuple] = None
    moves: Optional[str] = None
    layer: Optional[str] = None
    bound: Optional[float] = None


@dataclass
class Cell:
    """One workload of the manifest with what it names, loaded."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    @property
    def model(self) -> dict:
        return self.config["model"]


def _load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise ManifestError(f"{path} is missing") from None


def _metric(entry: dict, end_to_end: bool) -> Metric:
    wl = entry.get("workloads")
    return Metric(name=entry["name"], unit=entry["unit"], better=entry["better"],
                  source=entry["source"], end_to_end=end_to_end,
                  workloads=None if wl is None else tuple(wl), moves=entry.get("moves"),
                  layer=entry.get("layer"), bound=entry.get("bound"))


class Manifest:
    """``BENCHMARK.json`` of the checkout at ``root``, its files found under
    ``root/portbench``."""

    def __init__(self, data: dict, root: Path):
        self.data, self.root, self.base = data, root, root / "portbench"
        self.end_to_end = [_metric(m, True) for m in data["end_to_end"]]
        self.per_layer = [_metric(m, False) for m in data["per_layer"]]
        self.workloads = {w["name"]: w for w in data["workloads"]}
        self.configs = {c["name"]: c for c in data["configs"]}

    @classmethod
    def load(cls, root: Path) -> "Manifest":
        return cls(_load_json(root / "BENCHMARK.json"), root)

    def e2e_of(self, workload: str) -> List[Metric]:
        return [m for m in self.end_to_end if m.workloads is None or workload in m.workloads]

    def per_layer_of(self, workload: str) -> List[Metric]:
        """The per-layer metrics a traced run of ``workload`` reports: those
        that list it, and those without a list whose end-to-end metric the
        cell reports."""
        e2e = {m.name for m in self.e2e_of(workload)}
        return [m for m in self.per_layer
                if (workload in m.workloads if m.workloads is not None else m.moves in e2e)]

    def cell(self, workload: str) -> Cell:
        if workload not in self.workloads:
            raise ManifestError(f"no workload {workload!r}; the manifest has "
                                f"{sorted(self.workloads)}")
        w = self.workloads[workload]
        conf = self.configs[w["config"]]
        return Cell(name=workload, config_name=w["config"], traffic_name=w["traffic"],
                    chips=int(w["chips"]), config=_load_json(self.root / conf["file"]),
                    traffic=_load_json(self.base / "traffic" / f"{w['traffic']}.json"),
                    limits=_load_json(self.base / "limits" / f"{workload}.json"),
                    end_to_end=self.e2e_of(workload), per_layer=self.per_layer_of(workload))


def load_by_path(kind: str, name: str, base: Path = HERE):
    """The module ``<base>/<kind>/<name>.py`` (``base``: ``portbench/``),
    loaded from its file (a metric's name may hold dots)."""
    path = base / kind / f"{name}.py"
    if not path.exists():
        raise ManifestError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # as importlib's recipe: dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def check(data: dict) -> List[str]:
    """The manifest's faults against the benchmark's rules on names, units,
    keys and references (an empty list: none)."""
    bad: List[str] = []
    want = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
    if set(data) != want:
        bad.append(f"top-level keys {sorted(data)} are not {sorted(want)}")
        return bad
    names = {"configs": set(), "workloads": set(), "metrics": set()}

    def named(kind: str, entry: dict) -> None:
        n = entry.get("name", "")
        if not NAME.match(n):
            bad.append(f"{kind} name {n!r} breaks the name rule")
        if n in names[kind]:
            bad.append(f"{kind} name {n!r} twice")
        names[kind].add(n)

    for c in data["configs"]:
        named("configs", c)
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config {c.get('name')}: keys {sorted(c)}")
        for k in c.get("reduced", []):
            if not NAME.match(k):
                bad.append(f"reduced key {k!r} breaks the name rule")
    e2e = set()
    for m in data["end_to_end"]:
        named("metrics", m)
        e2e.add(m["name"])
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound", "source"}:
            bad.append(f"end-to-end metric {m['name']}: keys {sorted(m)}")
        if m.get("source") not in E2E_SOURCES:
            bad.append(f"end-to-end metric {m['name']}: source {m.get('source')!r}")
        if not 0.01 <= m.get("bound", 0) <= 0.25:
            bad.append(f"end-to-end metric {m['name']}: bound {m.get('bound')}")
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for m in data["per_layer"]:
        named("metrics", m)
        if set(m) - {"workloads"} != {"name", "unit", "better", "source", "layer", "moves"}:
            bad.append(f"per-layer metric {m['name']}: keys {sorted(m)}")
        if m.get("source") not in SOURCES:
            bad.append(f"per-layer metric {m['name']}: source {m.get('source')!r}")
        if m.get("moves") not in e2e:
            bad.append(f"per-layer metric {m['name']}: moves {m.get('moves')!r}")
    for m in data["end_to_end"] + data["per_layer"]:
        if not UNIT.match(m.get("unit", "")):
            bad.append(f"metric {m['name']}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            bad.append(f"metric {m['name']}: better {m.get('better')!r}")
    pairs = set()
    for w in data["workloads"]:
        named("workloads", w)
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload {w.get('name')}: keys {sorted(w)}")
        if w.get("config") not in names["configs"]:
            bad.append(f"workload {w['name']}: no config {w.get('config')!r}")
        if not NAME.match(w.get("traffic", "")):
            bad.append(f"workload {w['name']}: traffic name {w.get('traffic')!r}")
        if w.get("chips") not in (1, 4):
            bad.append(f"workload {w['name']}: chips {w.get('chips')}")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            bad.append(f"workload {w['name']}: pair {pair} twice")
        pairs.add(pair)
        for text in (w.get("why", ""),):
            if not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
                bad.append(f"workload {w['name']}: why of {len(text)} characters")
    for m in data["end_to_end"] + data["per_layer"]:
        for wl in m.get("workloads", []):
            if wl not in names["workloads"]:
                bad.append(f"metric {m['name']}: no workload {wl!r}")
    used = {w["config"] for w in data["workloads"]}
    for c in names["configs"] - used:
        bad.append(f"config {c} is used by no cell")
    return bad
