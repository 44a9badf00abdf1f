"""Test harness config.

By default the suite runs on the CPU with 8 simulated devices
(``--xla_force_host_platform_device_count=8``), which is how the sharding
logic is exercised without a card (SURVEY.md §4). ``-m gpu`` selects the
lane of tests marked ``gpu``; it leaves the platform alone, so JAX takes
the accelerator, and the ``gpu`` fixture skips those tests where JAX finds
no GPU.
"""
import os

import pytest


def _gpu_lane(config) -> bool:
    expr = config.getoption("markexpr") or ""
    return "gpu" in expr and "not gpu" not in expr


def pytest_configure(config):
    # Runs before any test module is imported, and so before JAX picks its
    # backend: the platform and the cache must be set before that.
    if not _gpu_lane(config):
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    # Every model instance jits its own sweep closure, so the suite is
    # compile-bound; the persistent cache is keyed by HLO hash, so library
    # changes recompile while unchanged programs load in milliseconds.
    from pyglm_tpu.utils.utils import enable_compile_cache

    enable_compile_cache()


@pytest.fixture(scope="session")
def gpu():
    """Skip unless JAX's default device is a GPU. Every test marked ``gpu``
    requests it (directly or through its module fixtures, so no expensive
    fixture runs first). Decided here, at run time, so every worker
    collects the same tests."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests/ -m gpu` on "
                    "a machine with one")
