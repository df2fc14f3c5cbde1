"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the repository's root (a few minutes on the CPU). They import neither jax
nor the JAX package, so this file, not ``tests/conftest.py``, registers
the ``cuda`` marker of the tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs a benchmark cell on the card; skips where torch finds "
        "no CUDA device")
