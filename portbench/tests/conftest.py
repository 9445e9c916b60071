"""The benchmark's tests: its own root and the port's ``src`` on the path,
and the marker of the tests that need a CUDA device."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where none is present "
        "(run on the card with -m cuda)")
