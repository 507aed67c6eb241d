"""pytest settings of the benchmark's own tests (portbench/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (run on the card with "
        "`python3 -m pytest portbench/tests -m card`)")
