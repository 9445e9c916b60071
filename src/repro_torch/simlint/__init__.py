"""simlint — the repo's AST-based determinism linter.

Every headline guarantee this reproduction makes (bit-identical RunReports
across the event/epoch engines and across shared-clock/partitioned/
partitioned-mp execution) rests on source-level discipline: no wall-clock
reads in sim paths, no unseeded or global-state RNG, no iteration over
unordered containers in scheduler-adjacent code, int64 counter accumulation,
and frozen configs that round-trip exactly.  ``simlint`` turns those
invariants from test-suite folklore into gating, named, suppressible rules:

==== =======================================================================
id   what it catches
==== =======================================================================
SL001 wall-clock call (``time.time``/``perf_counter``/``monotonic``/
      ``datetime.now``) outside the wall-mode allowlist
SL002 RNG without an explicit seed/Generator (bare ``np.random.*``,
      ``random.*``, unseeded ``default_rng()``)
SL003 iteration over a ``set`` in files that touch
      ``EventScheduler``/``DomainScheduler`` (unordered → nondeterministic
      event order)
SL004 float accumulation into counters the telemetry layer declares int64
SL005 mutable default or missing ``frozen=True`` on a config dataclass
SL006 ``to_dict``/``from_dict`` field-coverage mismatch on a config
      dataclass
SL007 ``os.environ``/``os.getpid``/``id()``-keyed ordering inside
      mp-worker code paths
==== =======================================================================

Run it as ``python -m repro_torch.simlint [paths...]``; a configuration (a
``simlint.toml``-style file, or a ``[tool.simlint]`` table) is read only where
``--config`` names it, suppressions are inline
``# simlint: disable=SL00N -- reason`` comments, and
``simlint_torch_baseline.json`` lets pre-existing accepted findings ride while
new violations gate CI.

Own copy, in the PyTorch port, of ``src/repro/simlint/``: the same plain
Python, rules SL001–SL007 with the same logic, ids and messages, on the
port's sim path ``src/repro_torch/{core,exp,serving}``. It discovers no
config file and its baseline has a name of its own, so by default it never
reads the JAX package's ``simlint.toml`` or ``simlint_baseline.json``, nor
anything outside the working directory (see
:mod:`repro_torch.simlint.config`).
"""
from .baseline import load_baseline, split_new, write_baseline
from .checker import collect_files, lint_paths, lint_source
from .cli import main
from .config import SimlintConfig, load_config
from .rules import Finding, Rule, RULES

__all__ = [
    "Finding", "Rule", "RULES", "SimlintConfig", "load_config",
    "collect_files", "lint_paths", "lint_source",
    "load_baseline", "split_new", "write_baseline", "main",
]
