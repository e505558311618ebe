"""Shared pytest settings: registers the ``gpu`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device and nvcc (launches a hand-written CUDA "
        "kernel, which has no CPU mode); skipped with a reason on hosts "
        "without a card — run with `python -m pytest -m gpu "
        "tests/test_torch_gpu.py` on a machine that has one")
