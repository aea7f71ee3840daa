"""Registers the ``gpu`` marker: tests that need a CUDA card. They decide
inside the test (a fixture) whether a card is present and skip without one,
so that every worker collects the same tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none "
        "(run them with `python -m pytest -q -m gpu tests/test_torch_gpu.py`)")
