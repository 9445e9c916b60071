"""What one run measured, as the metric readers see it. A driver fills the
fields its traffic has; a reader that finds its field empty returns None
and the metric is left out of the result line."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .manifest import Cell
from .trace import Trace


@dataclass
class Run:
    cell: Cell
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    # training: the window's steps and the trainer's counters over them
    steps: int = 0
    tokens: int = 0
    step_s: List[float] = field(default_factory=list)
    issue_s: List[float] = field(default_factory=list)
    feed_s: List[float] = field(default_factory=list)
    # serving: every request's time to its first token and time per output
    # token, each prefill's and each decode step's seconds, and the
    # prefills' prompt lengths
    ttft_s: List[float] = field(default_factory=list)
    tpot_s: List[float] = field(default_factory=list)
    requests: int = 0
    prefill_s: List[float] = field(default_factory=list)
    prefill_lens: List[int] = field(default_factory=list)
    batch: int = 0
    decode_s: List[float] = field(default_factory=list)
    # the traced stretch (--trace 1) and what it covered
    trace: Optional[Trace] = None
    # what the timed path produced, for the comparison with the reference
    answers: object = None
    # the compared numbers: name -> (value, limit)
    checks: Dict[str, tuple] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.cell.model

    @property
    def traffic(self) -> dict:
        return self.cell.traffic
