"""Stable RNG-seed derivation from config content (not positional counters).

Every per-client and per-replicate seed used to be a positional offset
(``traffic.seed + client_index``, submission-order trial counters).  That
made seeds depend on *where* a config sat in a sweep or in what order trials
were submitted — exactly what a parallel runner shuffles.  Here seeds derive
from the sha256 of the config's canonical JSON plus a role salt and an
index, so:

* the same config produces the same seeds no matter how (or where) it runs;
* *execution-only* knobs — the config ``name``, the partition mode/worker
  count, and the traffic ``engine`` — are scrubbed before hashing, because
  two runs that differ only in how they are executed must stay bit-identical
  (the partition parity contract and the engine parity contract both lean on
  this);
* physics knobs (including ``traffic.seed`` itself) stay in the hash, so
  distinct experiments stay decorrelated.

Own copy, in the PyTorch port, of ``src/repro/exp/seeding.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict

__all__ = ["EXECUTION_ONLY_KEYS", "scrub_execution_keys",
           "config_fingerprint", "derive_seed"]

# top-level config keys that select *how* a run executes, never *what* it
# simulates; they must not perturb any derived seed
EXECUTION_ONLY_KEYS = ("name", "partition", "partition_workers",
                       "partition_sanitize")


# config keys that are *inert at their default value*: they were added after
# fingerprints already seeded real experiments, so when unset they are elided
# before hashing — a config that doesn't use the feature hashes (and seeds)
# exactly as it did before the feature existed.  Non-default values stay in
# the hash, keeping distinct experiments decorrelated.
_INERT_WHEN_NONE = ("node_switch", "client_switch")          # topology level
_INERT_SWITCH_WHEN_NONE = ("pipeline", "trunk")              # switch level
_CC_KEYS = ("cc_mode", "cc_window_ns", "cc_gain", "cc_min_gbps",
            "cc_increase_gbps", "cc_max_inflight")           # traffic level


def scrub_execution_keys(cfg_dict: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a config dict with execution-only knobs removed (top-level
    ``name``/``partition``/``partition_workers``/``partition_sanitize`` and
    ``traffic.engine``) and later-added feature knobs elided when inert
    (switch ``pipeline``/``trunk`` unset, ``cc_mode`` fixed, default
    two-switch placement)."""
    out = {k: v for k, v in cfg_dict.items() if k not in EXECUTION_ONLY_KEYS}
    for key in _INERT_WHEN_NONE:
        if key in out and out[key] is None:
            del out[key]
    traffic = out.get("traffic")
    if isinstance(traffic, dict):
        traffic = {k: v for k, v in traffic.items() if k != "engine"}
        if traffic.get("cc_mode", "fixed") == "fixed":
            # every cc_* knob is inert while cc is off
            traffic = {k: v for k, v in traffic.items() if k not in _CC_KEYS}
        out["traffic"] = traffic
    switch = out.get("switch")
    if isinstance(switch, dict):
        switch = dict(switch)
        for key in _INERT_SWITCH_WHEN_NONE:
            if switch.get(key) is None:
                switch.pop(key, None)
        out["switch"] = switch
    return out


def config_fingerprint(cfg_dict: Dict[str, Any]) -> str:
    """sha256 hex digest of the scrubbed config's canonical JSON.

    Canonical == sorted keys, minimal separators — byte-stable across dict
    insertion orders and JSON round-trips.
    """
    canon = json.dumps(scrub_execution_keys(cfg_dict), sort_keys=True,
                       separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def derive_seed(fingerprint: str, index: int, salt: str = "") -> int:
    """A stable 63-bit seed for role ``salt`` + ``index`` under one config.

    ``np.random.default_rng`` and ``random.Random`` both accept it; distinct
    (fingerprint, salt, index) triples give independent streams.
    """
    h = hashlib.sha256(
        f"{fingerprint}:{salt}:{int(index)}".encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big") >> 1
