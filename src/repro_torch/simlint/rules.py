"""Rule registry + the Finding record every checker emits.

A rule is pure metadata (id, title, one-line fix hint); the detection logic
lives in :mod:`repro_torch.simlint.checker`.  Keeping the registry declarative
means ``--list-rules``, the docs table, and the per-finding hint all render
from one source of truth.

Own copy, in the PyTorch port, of ``src/repro/simlint/rules.py``: the same
plain Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    hint: str


RULES: Dict[str, Rule] = {r.id: r for r in (
    Rule("SL001",
         "wall-clock call in a sim path",
         "read virtual time from the SimClock; intentionally wall-clock "
         "code (wall-mode pacing, bench timing) gets "
         "`# simlint: disable=SL001 -- <why>`"),
    Rule("SL002",
         "RNG without an explicit seed",
         "use np.random.default_rng(seed) with a seed derived via "
         "repro_torch.exp.seeding; never the global numpy/stdlib RNG state"),
    Rule("SL003",
         "iteration over an unordered set in scheduler-adjacent code",
         "iterate sorted(...) or an insertion-ordered dict/list so event "
         "order cannot depend on hash seeds"),
    Rule("SL004",
         "float accumulation into an int64 telemetry counter",
         "accumulate integers and convert once at the boundary "
         "(int(round(x))); float += drifts across platforms"),
    Rule("SL005",
         "config dataclass not frozen / mutable default",
         "declare @dataclass(frozen=True) and use "
         "field(default_factory=...) for container defaults"),
    Rule("SL006",
         "to_dict/from_dict field-coverage mismatch",
         "cover every dataclass field in the round-trip body, or use the "
         "generic _config_to_dict(self) / cls(**d) forms"),
    Rule("SL007",
         "process-identity-dependent value in an mp-worker path",
         "key by domain/trial index, not pid, id(), or environment reads "
         "that can differ across workers"),
)}


@dataclass
class Finding:
    """One violation: where, which rule, and what exactly."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    @property
    def hint(self) -> str:
        return RULES[self.rule].hint

    def render(self, with_hint: bool = True) -> str:
        head = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        if not with_hint:
            return head
        return f"{head}\n    hint: {self.hint}"
