"""Baseline file support: let accepted pre-existing findings ride while new
violations gate.

A baseline entry is ``{"path", "rule", "text"}`` where ``text`` is the
stripped source line — content-addressed rather than line-numbered, so
unrelated edits above a baselined finding don't invalidate it.  Matching is
multiset-style: N baseline entries for one (path, rule, text) absorb at most
N findings.

Own copy, in the PyTorch port, of ``src/repro/simlint/baseline.py``: the same
plain Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple

from .rules import Finding

Key = Tuple[str, str, str]


def _line_text(root: str, f: Finding,
               cache: Dict[str, List[str]]) -> str:
    if f.path not in cache:
        try:
            with open(os.path.join(root, f.path), encoding="utf-8") as fh:
                cache[f.path] = fh.read().splitlines()
        except OSError:
            cache[f.path] = []
    lines = cache[f.path]
    return lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""


def finding_key(root: str, f: Finding,
                cache: Dict[str, List[str]]) -> Key:
    return (f.path, f.rule, _line_text(root, f, cache))


def load_baseline(path: str) -> Counter:
    """Baseline file → Counter of (path, rule, text) keys.  Missing file ==
    empty baseline."""
    if not os.path.isfile(path):
        return Counter()
    with open(path, encoding="utf-8") as fh:
        entries = json.load(fh)
    return Counter((e["path"], e["rule"], e.get("text", ""))
                   for e in entries)


def split_new(findings: Sequence[Finding], baseline: Counter,
              root: str = ".") -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined) partition of ``findings`` against the baseline."""
    budget = Counter(baseline)
    cache: Dict[str, List[str]] = {}
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        key = finding_key(root, f, cache)
        if budget[key] > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


def write_baseline(path: str, findings: Sequence[Finding],
                   root: str = ".") -> int:
    """Write the current findings as the new baseline; returns the count."""
    cache: Dict[str, List[str]] = {}
    entries = [{"path": f.path, "rule": f.rule,
                "text": _line_text(root, f, cache)}
               for f in sorted(findings,
                               key=lambda f: (f.path, f.line, f.rule))]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(entries, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return len(entries)
