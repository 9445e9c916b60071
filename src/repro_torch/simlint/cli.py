"""``python -m repro_torch.simlint`` — the gating entry point.

Exit status: 0 when every finding is suppressed inline or absorbed by the
baseline; 1 when any new finding remains (printed with file:line:col, rule
id, and a fix hint); 2 on usage errors.

Own copy, in the PyTorch port, of ``src/repro/simlint/cli.py``: the same plain
Python, run as ``python -m repro_torch.simlint``, on the port's defaults
(:mod:`repro_torch.simlint.config`).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .baseline import load_baseline, split_new, write_baseline
from .checker import lint_paths
from .config import load_config
from .rules import RULES


def _list_rules() -> str:
    lines = ["simlint determinism rules:"]
    for r in RULES.values():
        lines.append(f"  {r.id}  {r.title}")
        lines.append(f"         fix: {r.hint}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.simlint",
        description="AST-based determinism linter for the sim core "
                    "(rules SL001-SL007).")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "configured sim-path scope)")
    ap.add_argument("--config", default=None,
                    help="path to a simlint.toml-style config (default: "
                         "none is read; the port's defaults, rooted at the "
                         "cwd)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON path (default: from config, "
                         "simlint_torch_baseline.json next to the config, "
                         "or in the cwd)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline "
                         "file and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--no-hints", action="store_true",
                    help="one line per finding (no fix hints)")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    cfg = load_config(args.config)
    paths = args.paths or [os.path.join(cfg.root, p) for p in cfg.paths]
    findings = lint_paths(paths, cfg)

    baseline_path = args.baseline or os.path.join(cfg.root, cfg.baseline)
    if args.write_baseline:
        n = write_baseline(baseline_path, findings, root=cfg.root)
        print(f"simlint: wrote {n} finding(s) to {baseline_path}")
        return 0

    if args.no_baseline:
        new, old = list(findings), []
    else:
        new, old = split_new(findings, load_baseline(baseline_path),
                             root=cfg.root)

    for f in new:
        print(f.render(with_hint=not args.no_hints))
    if new:
        print(f"simlint: {len(new)} new finding(s)"
              + (f" ({len(old)} baselined)" if old else ""))
        return 1
    tail = f" ({len(old)} baselined)" if old else ""
    print(f"simlint: clean{tail}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    sys.exit(main())
