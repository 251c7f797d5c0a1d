"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding paths are exercised without accelerator hardware (SURVEY.md §4
rebuild implication (d)), and enable x64 before JAX initializes.

Tests that need a GPU carry the ``gpu`` marker. Each one checks inside
the test whether a card is present, skips without one, and runs its GPU
work in a child process that does not inherit the CPU pin below. Run
them on the card with ``python -m pytest tests/ -m gpu``."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on a machine without "
        "one (run with -m gpu on the card)")


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Drop compiled-executable caches after every test module.

    Each XLA:CPU executable pins several mmap regions; with the full
    suite's ~500 jit-heavy tests the process deterministically crosses
    the kernel's default vm.max_map_count (65530) and LLVM's JIT
    segfaults inside a later compile (reproduced at
    test_linsolve_jit.py::test_linsolve_chain_indefinite_operator —
    ~30k maps by 16% of the suite). Per-module clearing keeps the map
    count bounded; cross-module executable reuse is rare, so the
    recompile cost is noise."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    import numpy as np

    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
