"""Pytest settings shared by the test suite: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with CUDA; skips (with a reason) elsewhere")
