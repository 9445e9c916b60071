"""Registers the marker of the tests that need a CUDA device."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where none is present "
        "(run on the card with -m cuda)")
