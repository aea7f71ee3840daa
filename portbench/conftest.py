"""Registers the ``gpu`` marker for the benchmark's tests: a test that needs
a CUDA card decides inside a fixture whether there is one and skips
without it, so that every pytest worker collects the same tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none "
        "(run them with `python -m pytest -q -m gpu portbench/tests`)")
