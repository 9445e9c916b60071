"""Cells measured but not yet in ``BENCHMARK.json`` (``portbench/candidates/``:
each file the manifest entries its cell would add), added to a copy of the
manifest's data the way a later change adds them, so that the tests drive
their files too."""
import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FOLDER = ROOT / "portbench" / "candidates"


def entries():
    return [json.loads(p.read_text()) for p in sorted(FOLDER.glob("*.json"))]


def with_candidates(data: dict) -> dict:
    data = copy.deepcopy(data)
    for c in entries():
        data["workloads"].append(c["workload"])
        for key in ("end_to_end", "per_layer"):
            have = {m["name"] for m in data[key]}
            data[key].extend(m for m in c[key] if m["name"] not in have)
    return data
